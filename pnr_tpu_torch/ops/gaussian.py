"""Separable Gaussian smoothing with edge-replicated borders.

Port of pnr_tpu/ops/gaussian.py (`gaussian_kernel`, `conv1d_along_axis`,
`imgaussian3d`; parity target `Frangi::imgaussian`,
pnr-vaa3d/frangi.cpp:563-877): normalized sampled 1-D kernels of
half-width ceil(3*sigma), applied as correlations along x, y and z, where
z uses sigma/zdist.

`imgaussian3d` routes by device, as JAX routes by backend: a CUDA tensor
runs K4 (`conv_yx`, the y then the x pass, straight from uint8) and K3
along z (`conv1d_axis`, ops/conv.py), the TPU branch of the JAX function;
a CPU tensor runs `imgaussian3d_plain`, the x, y, z shift-and-add chain
that JAX computes on the CPU and that K1 (ops/frangi_fused.py) is held to.

`conv1d_along_axis` is the 1-D correlation of the tube map build
(ops/zncc_fast.py), which JAX runs as an XLA shift-and-add, not as K3: a
CPU tensor runs that shift-and-add (K3's plain version without
`grad_border`, `conv1d_axis_plain` in ops/conv.py), a CUDA tensor runs
K3 without `grad_border` (`conv.launch_conv1d`: the same arithmetic per
output, clamped reads and the taps in order with fused multiply-adds;
at most 127 taps, else it raises with the size) or raises.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pnr_tpu_torch.ops.conv import conv1d_axis, conv1d_axis_plain, conv_yx, launch_conv1d

#: K3 launches of `conv1d_along_axis` (the tube map build's 1-D
#: correlations; not counted in conv.CONV1D_LAUNCHES)
LAUNCHES = 0


def gaussian_kernel(sigma: float) -> np.ndarray:
    """Normalized sampled Gaussian, half-width ceil(3*sigma) (frangi.cpp:568-579)."""
    half = int(math.ceil(3.0 * float(sigma)))
    x = np.arange(-half, half + 1, dtype=np.float64)
    g = np.exp(-(x * x) / (2.0 * float(sigma) ** 2))
    return (g / g.sum()).astype(np.float32)


def conv1d_along_axis(vol: torch.Tensor, kernel, axis: int) -> torch.Tensor:
    """Correlate a (Z, Y, X) `vol` with a 1-D `kernel` along `axis`,
    edge-replicated borders; float32 out."""
    if vol.device.type == "cpu":
        return conv1d_axis_plain(vol, kernel, axis)
    return _conv1d_cuda(vol, kernel, axis)


def _conv1d_cuda(vol, kernel, axis):
    global LAUNCHES
    out = launch_conv1d(vol, kernel, axis, False, "conv1d_along_axis")
    LAUNCHES += 1
    return out


def imgaussian3d(vol: torch.Tensor, sigma: float, zdist: float) -> torch.Tensor:
    """3-D Gaussian smoothing of a (Z, Y, X) volume (frangi.cpp:647-784) on
    its device. x and y use sigma; z uses sigma/zdist. Returns float32."""
    if vol.device.type == "cpu":
        return imgaussian3d_plain(vol, sigma, zdist)
    kxy = gaussian_kernel(sigma)
    v = conv_yx(vol, kxy, kxy)
    if v.shape[0] > 1:
        v = conv1d_axis(v, gaussian_kernel(float(sigma) / float(zdist)), 0)
    return v


def imgaussian3d_plain(vol: torch.Tensor, sigma: float, zdist: float) -> torch.Tensor:
    """The plain chain on any device: x, then y, then z."""
    v = vol.to(torch.float32)
    kxy = gaussian_kernel(sigma)
    v = conv1d_axis_plain(v, kxy, 2)
    v = conv1d_axis_plain(v, kxy, 1)
    if v.shape[0] > 1:
        v = conv1d_axis_plain(v, gaussian_kernel(float(sigma) / float(zdist)), 0)
    return v
