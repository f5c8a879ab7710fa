"""Separable Gaussian smoothing with edge-replicated borders.

Port of pnr_tpu/ops/gaussian.py (`gaussian_kernel`, `imgaussian3d`;
parity target `Frangi::imgaussian`, pnr-vaa3d/frangi.cpp:563-877):
normalized sampled 1-D kernels of half-width ceil(3*sigma), applied as
correlations along x, then y, then z, where z uses sigma/zdist. This is
the plain PyTorch chain that K1 (ops/frangi_fused.py) is held to.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def gaussian_kernel(sigma: float) -> np.ndarray:
    """Normalized sampled Gaussian, half-width ceil(3*sigma) (frangi.cpp:568-579)."""
    half = int(math.ceil(3.0 * float(sigma)))
    x = np.arange(-half, half + 1, dtype=np.float64)
    g = np.exp(-(x * x) / (2.0 * float(sigma) ** 2))
    return (g / g.sum()).astype(np.float32)


def conv1d_along_axis(vol: torch.Tensor, kernel, axis: int) -> torch.Tensor:
    """Correlate `vol` with a 1-D `kernel` along `axis`, edge-replicated
    borders, summing the taps in order (one product and one add per tap,
    as the JAX shift-and-add does)."""
    kernel = np.asarray(kernel, np.float32)
    k = kernel.shape[0]
    half = k // 2
    n = vol.shape[axis]
    idx = torch.arange(-half, n + half, device=vol.device).clamp_(0, n - 1)
    xp = vol.index_select(axis, idx)
    out = None
    for j in range(k):
        term = float(kernel[j]) * xp.narrow(axis, j, n)
        out = term if out is None else out + term
    return out


def imgaussian3d(vol: torch.Tensor, sigma: float, zdist: float) -> torch.Tensor:
    """3-D Gaussian smoothing of a (Z, Y, X) volume (frangi.cpp:647-784).

    x and y use sigma; z uses sigma/zdist. Returns float32."""
    v = vol.to(torch.float32)
    kxy = gaussian_kernel(sigma)
    v = conv1d_along_axis(v, kxy, axis=2)
    v = conv1d_along_axis(v, kxy, axis=1)
    if v.shape[0] > 1:
        v = conv1d_along_axis(v, gaussian_kernel(float(sigma) / float(zdist)), axis=0)
    return v
