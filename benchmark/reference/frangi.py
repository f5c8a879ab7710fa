"""Plain multi-scale 3-D Frangi vesselness, its uint8 J8 and quantized directions.

The filter of the upstream plugin (Frangi::frangi3d, pnr-vaa3d/frangi.cpp)
written out in plain torch operations in a chosen dtype, with nothing of
the program under test: per sigma, the stack smoothed by a normalised
sampled Gaussian of half-width ceil(3 sigma) (z: sigma / zdist) with
replicated borders; the Hessian as first differences applied twice
(central inside, one-sided at the borders) times sigma^2; the closed-form
eigenvalues of each symmetric 3 x 3 and the unit eigenvector of the one
of least magnitude; the vesselness

    J = (1 - exp(-Ra^2 / 2a^2)) exp(-Rb^2 / 2b^2) (1 - exp(-S^2 / 2c^2)),

zero where l2 > 0 or l3 > 0 or J is NaN; a later sigma wins where it is
strictly greater. J8 is J min-max normalised to 0..255 (the minimum over
the first sigma's J, the maximum over the final J), rounded half to even;
each direction component is quantized as round((v + 1) / 2 * 255).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

_TINY = 1.175494e-38


def gaussian_taps(sigma: float) -> np.ndarray:
    half = int(math.ceil(3.0 * float(sigma)))
    t = np.arange(-half, half + 1, dtype=np.float64)
    g = np.exp(-(t * t) / (2.0 * float(sigma) ** 2))
    return g / g.sum()


def correlate1d(v: torch.Tensor, taps, axis: int) -> torch.Tensor:
    """Correlate along `axis` with replicated borders (clamped reads)."""
    n = v.shape[axis]
    half = (len(taps) - 1) // 2
    idx = torch.arange(n, device=v.device)
    out = torch.zeros_like(v)
    for k, w in enumerate(taps):
        src = (idx + (k - half)).clamp_(0, n - 1)
        out.add_(v.index_select(axis, src), alpha=float(w))
    return out


def gradient(f: torch.Tensor, axis: int) -> torch.Tensor:
    n = f.shape[axis]
    lo = f.narrow(axis, 1, 1) - f.narrow(axis, 0, 1)
    hi = f.narrow(axis, n - 1, 1) - f.narrow(axis, n - 2, 1)
    mid = (f.narrow(axis, 2, n - 2) - f.narrow(axis, 0, n - 2)) * 0.5
    return torch.cat([lo, mid, hi], dim=axis)


def _eig_least(a11, a22, a33, a12, a13, a23):
    """Eigenvalues ordered by magnitude (l1, l2, l3) and the unit
    eigenvector of l1, by the trigonometric closed form."""
    q = (a11 + a22 + a33) / 3.0
    b11, b22, b33 = a11 - q, a22 - q, a33 - q
    off = a12 * a12 + a13 * a13 + a23 * a23
    p2 = b11 * b11 + b22 * b22 + b33 * b33 + 2.0 * off
    p = torch.sqrt((p2 / 6.0).clamp(min=0.0))
    ps = p.clamp(min=1e-20)
    c11, c22, c33, c12, c13, c23 = b11 / ps, b22 / ps, b33 / ps, a12 / ps, a13 / ps, a23 / ps
    det = (c11 * (c22 * c33 - c23 * c23) - c12 * (c12 * c33 - c23 * c13)
           + c13 * (c12 * c23 - c22 * c13))
    phi = torch.arccos((det / 2.0).clamp(-1.0, 1.0)) / 3.0
    e3 = q + 2.0 * p * torch.cos(phi)
    e1 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e2 = 3.0 * q - e3 - e1
    flat = p2 <= 1e-20
    e1, e2, e3 = (torch.where(flat, q, e) for e in (e1, e2, e3))
    ev = torch.stack([e1, e2, e3])
    order = ev.abs().argsort(dim=0, stable=True)
    l1, l2, l3 = torch.gather(ev, 0, order)
    # eigenvector of l1: the longest cross product of two rows of A - l1 I
    r1 = (a11 - l1, a12, a13)
    r2 = (a12, a22 - l1, a23)
    r3 = (a13, a23, a33 - l1)

    def cross(u, v):
        return (u[1] * v[2] - u[2] * v[1], u[2] * v[0] - u[0] * v[2], u[0] * v[1] - u[1] * v[0])

    best, bn = None, None
    for c in (cross(r1, r2), cross(r1, r3), cross(r2, r3)):
        n = c[0] * c[0] + c[1] * c[1] + c[2] * c[2]
        if best is None:
            best, bn = c, n
        else:
            take = n > bn
            best = tuple(torch.where(take, ci, bi) for ci, bi in zip(c, best))
            bn = torch.where(take, n, bn)
    degen = bn <= 1e-20
    inv = torch.rsqrt(bn.clamp(min=1e-20))
    vx = torch.where(degen, torch.ones_like(inv), best[0] * inv)
    vy = torch.where(degen, torch.zeros_like(inv), best[1] * inv)
    vz = torch.where(degen, torch.zeros_like(inv), best[2] * inv)
    return l1, l2, l3, vx, vy, vz


def quantize(v: torch.Tensor) -> torch.Tensor:
    return torch.round((v.float() + 1.0) / 2.0 * 255.0).clamp(0.0, 255.0).to(torch.uint8)


def frangi_j8(vol_u8: torch.Tensor, sigmas, zdist: float, alpha: float, beta: float, c: float,
              dtype=torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """(J8 (Z, Y, X) uint8, quantized directions (3, Z, Y, X) uint8) of a
    uint8 stack, computed in `dtype` on the stack's device."""
    f0 = vol_u8.to(dtype)
    j = jmin = qdir = None
    for si, sig in enumerate(sigmas):
        s = float(sig)
        f = correlate1d(f0, gaussian_taps(s), 2)
        f = correlate1d(f, gaussian_taps(s), 1)
        f = correlate1d(f, gaussian_taps(s / zdist), 0)
        s2 = s * s
        dz = gradient(f, 0)
        dzz = gradient(dz, 0) * s2
        del dz
        dy = gradient(f, 1)
        dyy = gradient(dy, 1) * s2
        dyz = gradient(dy, 0) * s2
        del dy
        dx = gradient(f, 2)
        del f
        dxx = gradient(dx, 2) * s2
        dxy = gradient(dx, 1) * s2
        dxz = gradient(dx, 0) * s2
        del dx
        l1, l2, l3, vx, vy, vz = _eig_least(dxx, dyy, dzz, dxy, dxz, dyz)
        del dxx, dyy, dzz, dxy, dxz, dyz
        a1, a2, a3 = l1.abs(), l2.abs(), l3.abs()
        ra = a2 / a3
        rb = a1 / torch.sqrt(a2 * a3)
        sn = torch.sqrt(a1 * a1 + a2 * a2 + a3 * a3)
        v = ((1.0 - torch.exp(-(ra * ra) / (2.0 * alpha * alpha)))
             * torch.exp(-(rb * rb) / (2.0 * beta * beta))
             * (1.0 - torch.exp(-(sn * sn) / (2.0 * c * c))))
        v = torch.where((l2 > 0) | (l3 > 0) | torch.isnan(v), torch.zeros_like(v), v)
        q = torch.stack([quantize(vx), quantize(vy), quantize(vz)])
        del l1, l2, l3, vx, vy, vz, a1, a2, a3, ra, rb, sn
        if si == 0:
            j, jmin, qdir = v, v.min(), q
        else:
            upd = v > j
            j = torch.where(upd, v, j)
            qdir = torch.where(upd[None], q, qdir)
    jf, lo, hi = j.float(), jmin.float(), j.max().float()
    span = hi - lo
    if float(span.abs()) <= _TINY:
        return torch.zeros_like(vol_u8), qdir
    j8 = torch.round((jf - lo) / span * 255.0).clamp(0.0, 255.0).to(torch.uint8)
    return j8, qdir


def decode_dirs(qdir: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
    """Unit directions (N, 3) float32 decoded from the quantized volumes at
    integer voxels `xyz` (N, 3) (x, y, z): u = q / 255 * 2 - 1, normalised."""
    x, y, z = xyz[:, 0].long(), xyz[:, 1].long(), xyz[:, 2].long()
    u = qdir[:, z, y, x].T.float() / 255.0 * 2.0 - 1.0
    n = torch.linalg.vector_norm(u, dim=1, keepdim=True)
    return u / torch.where(n > 0, n, torch.ones_like(n))
