"""Batched closed-form symmetric 3x3 eigendecomposition for vesselness.

Port of pnr_tpu/ops/eig3.py (the reference's EISPACK tred2/tql2 per
voxel, pnr-vaa3d/frangi.cpp:1269-1493, replaced by the trigonometric
method with the real arccos): eigenvalues sorted by |lambda| ascending,
plus the unit eigenvector of the |lambda|-smallest one (the vessel
direction, frangi.cpp:240-250).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

_EPS = 1e-20
_TWO_PI_OVER_3 = 2.0 * math.pi / 3.0


def _eigenvalues3(a11, a22, a33, a12, a13, a23):
    """Closed-form eigenvalues of a symmetric 3x3, ascending order."""
    p1 = a12 * a12 + a13 * a13 + a23 * a23
    q = (a11 + a22 + a33) / 3.0
    b11, b22, b33 = a11 - q, a22 - q, a33 - q
    p2 = b11 * b11 + b22 * b22 + b33 * b33 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=0.0))
    psafe = torch.clamp(p, min=_EPS)
    c11, c22, c33 = b11 / psafe, b22 / psafe, b33 / psafe
    c12, c13, c23 = a12 / psafe, a13 / psafe, a23 / psafe
    detb = (
        c11 * (c22 * c33 - c23 * c23)
        - c12 * (c12 * c33 - c23 * c13)
        + c13 * (c12 * c23 - c22 * c13)
    )
    r = torch.clamp(detb / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    e_hi = q + 2.0 * p * torch.cos(phi)
    e_lo = q + 2.0 * p * torch.cos(phi + _TWO_PI_OVER_3)
    e_mid = 3.0 * q - e_hi - e_lo
    diag = p2 <= _EPS
    e_lo = torch.where(diag, q, e_lo)
    e_mid = torch.where(diag, q, e_mid)
    e_hi = torch.where(diag, q, e_hi)
    return e_lo, e_mid, e_hi


def _eigenvector3(a11, a22, a33, a12, a13, a23, lam):
    """Eigenvector for `lam`: the largest cross product of rows of A - lam I."""
    r1 = (a11 - lam, a12, a13)
    r2 = (a12, a22 - lam, a23)
    r3 = (a13, a23, a33 - lam)

    def cross(u, v):
        return (
            u[1] * v[2] - u[2] * v[1],
            u[2] * v[0] - u[0] * v[2],
            u[0] * v[1] - u[1] * v[0],
        )

    c1, c2, c3 = cross(r1, r2), cross(r1, r3), cross(r2, r3)
    n1 = c1[0] * c1[0] + c1[1] * c1[1] + c1[2] * c1[2]
    n2 = c2[0] * c2[0] + c2[1] * c2[1] + c2[2] * c2[2]
    n3 = c3[0] * c3[0] + c3[1] * c3[1] + c3[2] * c3[2]
    use2 = n2 > n1
    vx = torch.where(use2, c2[0], c1[0])
    vy = torch.where(use2, c2[1], c1[1])
    vz = torch.where(use2, c2[2], c1[2])
    nbest = torch.where(use2, n2, n1)
    use3 = n3 > nbest
    vx = torch.where(use3, c3[0], vx)
    vy = torch.where(use3, c3[1], vy)
    vz = torch.where(use3, c3[2], vz)
    nbest = torch.where(use3, n3, nbest)
    # degenerate (repeated eigenvalue / zero matrix): emit +x
    degen = nbest <= _EPS
    inv = torch.rsqrt(torch.clamp(nbest, min=_EPS))
    one = torch.ones_like(vx)
    zero = torch.zeros_like(vx)
    return (
        torch.where(degen, one, vx * inv),
        torch.where(degen, zero, vy * inv),
        torch.where(degen, zero, vz * inv),
    )


def eigh3x3_vessel(dxx, dyy, dzz, dxy, dxz, dyz) -> Tuple[torch.Tensor, ...]:
    """Per-element eigensolve of [[dxx,dxy,dxz],[dxy,dyy,dyz],[dxz,dyz,dzz]].

    Returns (lam1, lam2, lam3, vx, vy, vz) with |lam1|<=|lam2|<=|lam3| and
    (vx, vy, vz) the unit eigenvector of lam1."""
    a11, a22, a33, a12, a13, a23 = (
        t.to(torch.float32) for t in (dxx, dyy, dzz, dxy, dxz, dyz)
    )
    e_lo, e_mid, e_hi = _eigenvalues3(a11, a22, a33, a12, a13, a23)
    ab_lo, ab_mid, ab_hi = e_lo.abs(), e_mid.abs(), e_hi.abs()
    s1 = ab_lo <= ab_mid
    p0, p1 = torch.where(s1, e_lo, e_mid), torch.where(s1, e_mid, e_lo)
    q0, q1 = torch.where(s1, ab_lo, ab_mid), torch.where(s1, ab_mid, ab_lo)
    s2 = ab_hi < q0
    s3 = ab_hi < q1
    lam1 = torch.where(s2, e_hi, p0)
    lam2 = torch.where(s2, p0, torch.where(s3, e_hi, p1))
    lam3 = torch.where(s2, p1, torch.where(s3, p1, e_hi))
    vx, vy, vz = _eigenvector3(a11, a22, a33, a12, a13, a23, lam1)
    return lam1, lam2, lam3, vx, vy, vz
