"""Separable Gaussian smoothing with edge-replicated borders.

Port of pnr_tpu/ops/gaussian.py (`gaussian_kernel`, `conv1d_along_axis`,
`imgaussian3d`, `imgaussian2d`, `imgaussian_xy`; parity target
`Frangi::imgaussian`,
pnr-vaa3d/frangi.cpp:563-877): normalized sampled 1-D kernels of
half-width ceil(3*sigma), applied as correlations along x, y and z, where
z uses sigma/zdist.

`imgaussian3d` routes by device, as JAX routes by backend: a CUDA tensor
runs K4 (`conv_yx`, the y then the x pass, straight from uint8) and K3
along z (`conv1d_axis`, ops/conv.py), the TPU branch of the JAX function;
a CPU tensor runs `imgaussian3d_plain`, the x, y, z shift-and-add chain
that JAX computes on the CPU and that K1 (ops/frangi_fused.py) is held to.

`imgaussian2d` (the 2-D filter's prefilter) and `imgaussian_xy` (the
soma stage's) keep JAX's order, the x pass and then the y pass, each a
1-D edge-replicated correlation accumulated in float32: on a CUDA tensor
both passes run K3 (`conv1d_axis`, counted in conv.CONV1D_LAUNCHES), on
a CPU tensor the shift-and-add. K4 is not used there: it fuses y then x,
the other order, and `imgaussian_xy` truncates to uint8, where a
different rounding can move a voxel across an integer.

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

from pnr_tpu_torch.ops.cuda import COUNT_LOCK
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
    with COUNT_LOCK:
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


def _xy(vol: torch.Tensor, sigma: float) -> torch.Tensor:
    """The x then the y pass over a (Z, Y, X) tensor, float32 out."""
    kxy = gaussian_kernel(sigma)
    return conv1d_axis(conv1d_axis(vol, kxy, 2), kxy, 1)


def imgaussian2d(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """2-D Gaussian smoothing of a (Y, X) image (frangi.cpp:563-645) on its
    device; float32 out."""
    return _xy(img[None], sigma)[0]


def imgaussian_xy(vol: torch.Tensor, sigma: float) -> torch.Tensor:
    """Per-slice xy Gaussian smoothing of a (Z, Y, X) volume on its device,
    returned as uint8: float accumulation, then clipped to [0, 255] and
    truncated (the reference's uint8 overload, frangi.cpp:786-877,
    truncates every partial sum; PARITY.md, divergence 3)."""
    return torch.clamp(_xy(vol, sigma), 0.0, 255.0).to(torch.uint8)


def imgaussian3d_plain(vol: torch.Tensor, sigma: float, zdist: float) -> torch.Tensor:
    """The plain chain on any device: x, then y, then z."""
    v = vol.to(torch.float32)
    kxy = gaussian_kernel(sigma)
    v = conv1d_axis_plain(v, kxy, 2)
    v = conv1d_axis_plain(v, kxy, 1)
    if v.shape[0] > 1:
        v = conv1d_axis_plain(v, gaussian_kernel(float(sigma) / float(zdist)), 0)
    return v
