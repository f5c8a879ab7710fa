"""Hessian of the Gaussian-smoothed volume via repeated first differences.

Port of pnr_tpu/ops/hessian.py (`hessian3d`, `hessian2d`; parity targets
`Frangi::hessian3d`, pnr-vaa3d/frangi.cpp:291-390, and `hessian2d`,
:507-561): each second
derivative is the first-difference operator applied twice (central
differences in the interior, one-sided at the borders, i.e.
`jnp.gradient` semantics), scaled by sigma^2. Cross terms derive from the
same intermediate first derivative as the reference (Dyz from Dy; Dxy,
Dxz from Dx).

`hessian3d` routes by device, as JAX routes by backend: a CUDA tensor
runs the TPU branch, nine K3 launches (ops/conv.py) with the taps
g1 = (-0.5, 0, 0.5) and g2 = sigma^2 * g1 and `grad_border`, in JAX's
order; a CPU tensor runs `hessian3d_plain`, the `gradient` * sigma^2
chain that JAX computes on the CPU.

`hessian2d` is JAX's on every backend: `imgaussian2d` (K3 on a card, the
shift-and-add on the CPU), then `gradient` twice and * sigma^2.
"""

from __future__ import annotations

from typing import Tuple

import torch

from pnr_tpu_torch.ops.conv import conv1d_axis
from pnr_tpu_torch.ops.gaussian import imgaussian2d, imgaussian3d, imgaussian3d_plain


def gradient(f: torch.Tensor, axis: int) -> torch.Tensor:
    """First difference: central interior, one-sided borders (frangi.cpp:306-311)."""
    n = f.shape[axis]
    if n < 2:
        raise ValueError(f"gradient needs at least 2 samples along axis {axis}")
    lo = (f.narrow(axis, 1, 1) - f.narrow(axis, 0, 1))
    hi = (f.narrow(axis, n - 1, 1) - f.narrow(axis, n - 2, 1))
    mid = (f.narrow(axis, 2, n - 2) - f.narrow(axis, 0, n - 2)) * 0.5
    return torch.cat([lo, mid, hi], dim=axis)


def hessian3d(vol: torch.Tensor, sigma: float, zdist: float) -> Tuple[torch.Tensor, ...]:
    """Scaled Hessian components of a (Z, Y, X) volume on its device:
    (Dzz, Dyy, Dyz, Dxx, Dxy, Dxz), each * sigma^2."""
    if vol.device.type == "cpu":
        return hessian3d_plain(vol, sigma, zdist)
    f = imgaussian3d(vol, sigma, zdist)
    s2 = float(sigma) * float(sigma)
    g1 = (-0.5, 0.0, 0.5)
    g2 = (-0.5 * s2, 0.0, 0.5 * s2)

    def d1(a, axis):
        return conv1d_axis(a, g1, axis, grad_border=True)

    def d2(a, axis):
        return conv1d_axis(a, g2, axis, grad_border=True)

    dz = d1(f, 0)
    dzz = d2(dz, 0)
    dz = None
    dy = d1(f, 1)
    dyy = d2(dy, 1)
    dyz = d2(dy, 0)
    dy = None
    dx = d1(f, 2)
    f = None
    dxx = d2(dx, 2)
    dxy = d2(dx, 1)
    dxz = d2(dx, 0)
    return dzz, dyy, dyz, dxx, dxy, dxz


def hessian3d_plain(vol: torch.Tensor, sigma: float, zdist: float) -> Tuple[torch.Tensor, ...]:
    """The plain chain on any device: `imgaussian3d_plain`, then
    `gradient` twice and * sigma^2."""
    f = imgaussian3d_plain(vol, sigma, zdist)
    s2 = float(sigma) * float(sigma)
    dz = gradient(f, 0)
    dzz = gradient(dz, 0) * s2
    dy = gradient(f, 1)
    dyy = gradient(dy, 1) * s2
    dyz = gradient(dy, 0) * s2
    dx = gradient(f, 2)
    dxx = gradient(dx, 2) * s2
    dxy = gradient(dx, 1) * s2
    dxz = gradient(dx, 0) * s2
    return dzz, dyy, dyz, dxx, dxy, dxz


def hessian2d(img: torch.Tensor, sigma: float) -> Tuple[torch.Tensor, ...]:
    """Scaled Hessian components of a (Y, X) image on its device:
    (Dyy, Dxy, Dxx), each * sigma^2."""
    f = imgaussian2d(img, sigma)
    s2 = float(sigma) * float(sigma)
    dy = gradient(f, 0)
    dyy = gradient(dy, 0) * s2
    dx = gradient(f, 1)
    dxx = gradient(dx, 1) * s2
    dxy = gradient(dx, 0) * s2
    return dyy, dxy, dxx
