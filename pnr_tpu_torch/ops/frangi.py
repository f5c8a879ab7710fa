"""Multi-scale 3-D Frangi vesselness with principal-direction output.

Port of pnr_tpu/ops/frangi.py (`frangi3d`, `frangi2d`, `_quantize_dir`,
`normalize_to_u8`; parity targets `Frangi::frangi3d`,
pnr-vaa3d/frangi.cpp:152-289, and `Frangi::frangi2d`, :392-505). Per
voxel and scale, with
Ra=|l2|/|l3|, Rb=|l1|/sqrt(|l2 l3|), S=||lambda||:

    J = (1 - exp(-Ra^2/2a^2)) * exp(-Rb^2/2b^2) * (1 - exp(-S^2/2C^2)),

zeroed where l2>0 or l3>0 (bright ridges, blackwhite=False), NaN->0. A
later sigma wins only where it is strictly greater; its lambda-smallest
eigenvector is quantized to uint8 as round((v+1)/2*255).

`frangi3d` is the unfused filter. It runs on its input's device: on a
card its Gaussian and difference passes run K4 and K3 (ops/gaussian.py,
ops/hessian.py, ops/conv.py), on the CPU the plain chain; eigen,
vesselness and merge are torch ops on either, as JAX runs them as XLA.
`frangi3d_plain` is that plain chain on any device: the plain version
the CUDA kernel K1 (ops/frangi_fused.py) is held to.

`frangi2d` is the 2-D (single-slice) filter: `hessian2d` (its Gaussian on
K3 on a card), then the closed-form 2 x 2 eigen-decomposition with the
reference's eigen-axis swap, as torch ops on either device.
"""

from __future__ import annotations

from typing import Sequence

import torch

from pnr_tpu_torch.ops.eig3 import eigh3x3_vessel
from pnr_tpu_torch.ops.hessian import hessian2d, hessian3d, hessian3d_plain

_FLT_MIN = 1.175494e-38


def _quantize_dir(v: torch.Tensor) -> torch.Tensor:
    """uint8 direction quantization: round((v+1)/2*255), half to even,
    clamped (frangi.cpp:240-242)."""
    val = torch.round(((v + 1.0) / 2.0) * 255.0)
    return torch.clamp(val, 0.0, 255.0).to(torch.uint8)


def _vesselness3d_scale(hessian, vol, sigma, zdist, alpha, beta, c, blackwhite):
    dzz, dyy, dyz, dxx, dxy, dxz = hessian(vol, sigma, zdist)
    lam1, lam2, lam3, vx, vy, vz = eigh3x3_vessel(dxx, dyy, dzz, dxy, dxz, dyz)
    a1, a2, a3 = lam1.abs(), lam2.abs(), lam3.abs()
    ra = a2 / a3
    rb = a1 / torch.sqrt(a2 * a3)
    s = torch.sqrt(a1 * a1 + a2 * a2 + a3 * a3)
    exp_ra = 1.0 - torch.exp(-(ra * ra) / (2.0 * alpha * alpha))
    exp_rb = torch.exp(-(rb * rb) / (2.0 * beta * beta))
    exp_s = 1.0 - torch.exp(-(s * s) / (2.0 * c * c))
    v = exp_ra * exp_rb * exp_s
    gate = ((lam2 < 0) | (lam3 < 0)) if blackwhite else ((lam2 > 0) | (lam3 > 0))
    v = torch.where(gate | torch.isnan(v), torch.zeros_like(v), v)
    return v, vx, vy, vz


def _frangi3d(hessian, vol, sigmas, zdist, alpha, beta, c, blackwhite, keep_first_scale):
    j = jmin = v1 = None
    out_vx = out_vy = out_vz = None
    for si, sig in enumerate(sigmas):
        v, vx, vy, vz = _vesselness3d_scale(
            hessian, vol, float(sig), float(zdist), alpha, beta, c, blackwhite
        )
        qx, qy, qz = _quantize_dir(vx), _quantize_dir(vy), _quantize_dir(vz)
        if si == 0:
            j, jmin = v, v.min()
            v1 = v if keep_first_scale else None
            out_vx, out_vy, out_vz = qx, qy, qz
        else:
            upd = v > j
            j = torch.where(upd, v, j)
            out_vx = torch.where(upd, qx, out_vx)
            out_vy = torch.where(upd, qy, out_vy)
            out_vz = torch.where(upd, qz, out_vz)
    if keep_first_scale:
        return j, jmin, j.max(), out_vx, out_vy, out_vz, v1
    return j, jmin, j.max(), out_vx, out_vy, out_vz


def frangi3d(
    vol: torch.Tensor,
    sigmas: Sequence[float],
    zdist: float,
    alpha: float = 0.5,
    beta: float = 0.5,
    c: float = 500.0,
    blackwhite: bool = False,
    keep_first_scale: bool = False,
):
    """Multi-scale 3-D Frangi over a (Z, Y, X) volume, on `vol`'s device
    (K4 and K3 on a card, the plain chain on the CPU).

    Returns (J, Jmin, Jmax, Vx, Vy, Vz): float32 vesselness, its min over
    the first-scale response and max over the final response (0-d
    tensors), and uint8-quantized directions. `keep_first_scale` appends
    the first scale's response, which the tiled engines
    (ops/frangi_blocked.py) reduce Jmin over."""
    return _frangi3d(hessian3d, vol, sigmas, zdist, alpha, beta, c, blackwhite, keep_first_scale)


def frangi3d_plain(
    vol: torch.Tensor,
    sigmas: Sequence[float],
    zdist: float,
    alpha: float = 0.5,
    beta: float = 0.5,
    c: float = 500.0,
    blackwhite: bool = False,
):
    """`frangi3d` through the plain chain on any device (K1's plain version)."""
    return _frangi3d(hessian3d_plain, vol, sigmas, zdist, alpha, beta, c, blackwhite, False)


def frangi2d(
    img: torch.Tensor,
    sigmas: Sequence[float],
    beta_one: float = 0.5,
    beta_two: float = 15.0,
    blackwhite: bool = False,
    keep_first_scale: bool = False,
):
    """Multi-scale 2-D Frangi over a (Y, X) image on its device
    (frangi.cpp:392-505).

    Replicates the reference's eigen-axis swap (frangi.cpp:444): Lambda1
    carries the larger |mu|; the emitted direction is the eigenvector v2
    when the swap triggers. Returns (J, Jmin, Jmax, Vx, Vy, Vz) with
    Vz == 0; `keep_first_scale` appends the first scale's response (see
    `frangi3d`)."""
    beta_term = 2.0 * beta_one * beta_one
    c_term = 2.0 * beta_two * beta_two
    j = jmin = v1 = None
    out_vx = out_vy = None
    for si, sig in enumerate(sigmas):
        dyy, dxy, dxx = hessian2d(img, float(sig))
        tmp = torch.sqrt((dxx - dyy) ** 2 + 4.0 * dxy * dxy)
        v2x = 2.0 * dxy
        v2y = dyy - dxx + tmp
        mag = torch.sqrt(v2x * v2x + v2y * v2y)
        safe = mag > 0
        den = torch.where(safe, mag, torch.ones_like(mag))
        v2x = torch.where(safe, v2x / den, v2x)
        v2y = torch.where(safe, v2y / den, v2y)
        v1x, v1y = -v2y, v2x
        mu1 = 0.5 * (dxx + dyy + tmp)
        mu2 = 0.5 * (dxx + dyy - tmp)
        check = mu1.abs() < mu2.abs()
        lam1 = torch.where(check, mu2, mu1)
        lam2 = torch.where(check, mu1, mu2)
        vecx = torch.where(check, v2x, v1x)
        vecy = torch.where(check, v2y, v1y)
        lam1 = torch.where(lam1 == 0, torch.full_like(lam1, _FLT_MIN), lam1)
        rb = (lam2 / lam1) ** 2
        s2 = lam1 * lam1 + lam2 * lam2
        v = torch.exp(-rb / beta_term) * (1.0 - torch.exp(-s2 / c_term))
        gate = (lam1 < 0) if blackwhite else (lam1 > 0)
        v = torch.where(gate, torch.zeros_like(v), v)
        vecn = torch.sqrt(vecx * vecx + vecy * vecy)
        vecn = torch.where(vecn > 0, vecn, torch.ones_like(vecn))
        qx, qy = _quantize_dir(vecx / vecn), _quantize_dir(vecy / vecn)
        if si == 0:
            j, jmin = v, v.min()
            v1 = v if keep_first_scale else None
            out_vx, out_vy = qx, qy
        else:
            upd = v > j
            j = torch.where(upd, v, j)
            out_vx = torch.where(upd, qx, out_vx)
            out_vy = torch.where(upd, qy, out_vy)
    out_vz = torch.zeros_like(out_vx)
    if keep_first_scale:
        return j, jmin, j.max(), out_vx, out_vy, out_vz, v1
    return j, jmin, j.max(), out_vx, out_vy, out_vz


def normalize_to_u8(j: torch.Tensor, jmin: torch.Tensor, jmax: torch.Tensor) -> torch.Tensor:
    """Min-max normalize float J to uint8 J8 (Advantra_plugin.cpp:2499-2512).
    JAX's chain of operations, on one float32 temporary updated in place,
    so that J, that temporary and J8 are all it holds at once."""
    span = jmax - jmin
    degenerate = span.abs() <= _FLT_MIN
    val = j - jmin
    val.div_(torch.where(degenerate, torch.ones_like(span), span)).mul_(255.0).round_()
    val.clamp_(0.0, 255.0).masked_fill_(degenerate, 0.0)
    return val.to(torch.uint8)
