"""NumPy/SciPy dense filters for the host one-shot engine.

A copy of pnr_tpu/hostpath/filters.py, imports aside.

Same math as the device ops (`pnr_tpu.ops.gaussian/hessian/eig3/frangi`
— parity targets `Frangi::frangi3d`, pnr-vaa3d/frangi.cpp:152-289) with
scipy.ndimage separable convolutions instead of XLA stencils. Results
agree with the device engines to f32 accumulation-order ulps (gated in
tests/test_hostpath.py); J8 may differ by at most a quantization level
on ties, which the quality gates treat identically.

Everything here is float32 like the device path.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
from scipy.ndimage import correlate1d

_FLT_MIN = 1.175494e-38
_EPS = 1e-20


def gaussian_kernel(sigma: float) -> np.ndarray:
    """Normalized sampled Gaussian, half-width ceil(3*sigma)
    (same table as ops.gaussian.gaussian_kernel; frangi.cpp:568-579)."""
    half = int(math.ceil(3.0 * float(sigma)))
    x = np.arange(-half, half + 1, dtype=np.float64)
    g = np.exp(-(x * x) / (2.0 * float(sigma) ** 2))
    return (g / g.sum()).astype(np.float32)


def conv1d(vol: np.ndarray, kernel: np.ndarray, axis: int) -> np.ndarray:
    """1-D correlation along `axis`, edge-replicated borders, f32."""
    return correlate1d(
        vol.astype(np.float32, copy=False), kernel, axis=axis, mode="nearest"
    )


def imgaussian3d(vol: np.ndarray, sigma: float, zdist: float) -> np.ndarray:
    """x/y at sigma, z at sigma/zdist (frangi.cpp:647-784)."""
    kxy = gaussian_kernel(sigma)
    v = conv1d(vol, kxy, 2)
    v = conv1d(v, kxy, 1)
    if v.shape[0] > 1:
        v = conv1d(v, gaussian_kernel(float(sigma) / float(zdist)), 0)
    return v


def imgaussian2d(img: np.ndarray, sigma: float) -> np.ndarray:
    k = gaussian_kernel(sigma)
    return conv1d(conv1d(img, k, 1), k, 0)


def _grad(f: np.ndarray, axis: int) -> np.ndarray:
    """jnp.gradient semantics: central interior, one-sided borders."""
    return np.gradient(f, axis=axis).astype(np.float32)


def hessian3d(vol, sigma: float, zdist: float):
    """(Dzz, Dyy, Dyz, Dxx, Dxy, Dxz) * sigma^2 (ops.hessian.hessian3d)."""
    f = imgaussian3d(vol, sigma, zdist)
    s2 = np.float32(float(sigma) * float(sigma))
    dz = _grad(f, 0)
    dzz = _grad(dz, 0) * s2
    dy = _grad(f, 1)
    dyy = _grad(dy, 1) * s2
    dyz = _grad(dy, 0) * s2
    dx = _grad(f, 2)
    dxx = _grad(dx, 2) * s2
    dxy = _grad(dx, 1) * s2
    dxz = _grad(dx, 0) * s2
    return dzz, dyy, dyz, dxx, dxy, dxz


def hessian2d(img, sigma: float):
    f = imgaussian2d(img, sigma)
    s2 = np.float32(float(sigma) * float(sigma))
    dy = _grad(f, 0)
    dyy = _grad(dy, 0) * s2
    dx = _grad(f, 1)
    dxx = _grad(dx, 1) * s2
    dxy = _grad(dx, 0) * s2
    return dyy, dxy, dxx


def _eigenvalues3(a11, a22, a33, a12, a13, a23):
    """NumPy port of ops.eig3._eigenvalues3 (closed-form, ascending)."""
    p1 = a12 * a12 + a13 * a13 + a23 * a23
    q = (a11 + a22 + a33) / 3.0
    b11, b22, b33 = a11 - q, a22 - q, a33 - q
    p2 = b11 * b11 + b22 * b22 + b33 * b33 + 2.0 * p1
    p = np.sqrt(np.maximum(p2 / 6.0, 0.0))
    psafe = np.maximum(p, _EPS)
    c11, c22, c33 = b11 / psafe, b22 / psafe, b33 / psafe
    c12, c13, c23 = a12 / psafe, a13 / psafe, a23 / psafe
    detb = (
        c11 * (c22 * c33 - c23 * c23)
        - c12 * (c12 * c33 - c23 * c13)
        + c13 * (c12 * c23 - c22 * c13)
    )
    r = np.clip(detb / 2.0, -1.0, 1.0)
    phi = np.arccos(r) / 3.0
    e_hi = q + 2.0 * p * np.cos(phi)
    e_lo = q + 2.0 * p * np.cos(phi + np.float32(2.0 * np.pi / 3.0))
    e_mid = 3.0 * q - e_hi - e_lo
    diag = p2 <= _EPS
    e_lo = np.where(diag, q, e_lo)
    e_mid = np.where(diag, q, e_mid)
    e_hi = np.where(diag, q, e_hi)
    return e_lo, e_mid, e_hi


def _eigenvector3(a11, a22, a33, a12, a13, a23, lam):
    """NumPy port of ops.eig3._eigenvector3."""
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
    vx = np.where(use2, c2[0], c1[0])
    vy = np.where(use2, c2[1], c1[1])
    vz = np.where(use2, c2[2], c1[2])
    nbest = np.where(use2, n2, n1)
    use3 = n3 > nbest
    vx = np.where(use3, c3[0], vx)
    vy = np.where(use3, c3[1], vy)
    vz = np.where(use3, c3[2], vz)
    nbest = np.where(use3, n3, nbest)

    degen = nbest <= _EPS
    inv = 1.0 / np.sqrt(np.maximum(nbest, _EPS))
    vx = np.where(degen, np.float32(1.0), vx * inv)
    vy = np.where(degen, np.float32(0.0), vy * inv)
    vz = np.where(degen, np.float32(0.0), vz * inv)
    return vx, vy, vz


def eigh3x3_vessel(dxx, dyy, dzz, dxy, dxz, dyz):
    """NumPy port of ops.eig3.eigh3x3_vessel (|lam| ascending + lam1's vec)."""
    a11 = dxx.astype(np.float32)
    a22 = dyy.astype(np.float32)
    a33 = dzz.astype(np.float32)
    a12 = dxy.astype(np.float32)
    a13 = dxz.astype(np.float32)
    a23 = dyz.astype(np.float32)

    e_lo, e_mid, e_hi = _eigenvalues3(a11, a22, a33, a12, a13, a23)
    ab_lo, ab_mid, ab_hi = np.abs(e_lo), np.abs(e_mid), np.abs(e_hi)
    s1 = ab_lo <= ab_mid
    p0, p1 = np.where(s1, e_lo, e_mid), np.where(s1, e_mid, e_lo)
    q0, q1 = np.where(s1, ab_lo, ab_mid), np.where(s1, ab_mid, ab_lo)
    s2 = ab_hi < q0
    s3 = ab_hi < q1
    lam1 = np.where(s2, e_hi, p0)
    lam2 = np.where(s2, p0, np.where(s3, e_hi, p1))
    lam3 = np.where(s2, p1, np.where(s3, p1, e_hi))

    vx, vy, vz = _eigenvector3(a11, a22, a33, a12, a13, a23, lam1)
    return lam1, lam2, lam3, vx, vy, vz


def _quantize_dir(v: np.ndarray) -> np.ndarray:
    val = np.round(((v + 1.0) / 2.0) * 255.0)
    return np.clip(val, 0.0, 255.0).astype(np.uint8)


def _vesselness3d_scale(vol, sigma, zdist, alpha, beta, c, blackwhite):
    dzz, dyy, dyz, dxx, dxy, dxz = hessian3d(vol, sigma, zdist)
    lam1, lam2, lam3, vx, vy, vz = eigh3x3_vessel(dxx, dyy, dzz, dxy, dxz, dyz)

    a1, a2, a3 = np.abs(lam1), np.abs(lam2), np.abs(lam3)
    with np.errstate(divide="ignore", invalid="ignore"):
        ra = a2 / a3
        rb = a1 / np.sqrt(a2 * a3)
        s = np.sqrt(a1 * a1 + a2 * a2 + a3 * a3)
        v = (
            (1.0 - np.exp(-(ra * ra) / np.float32(2.0 * alpha * alpha)))
            * np.exp(-(rb * rb) / np.float32(2.0 * beta * beta))
            * (1.0 - np.exp(-(s * s) / np.float32(2.0 * c * c)))
        )
    if blackwhite:
        v = np.where((lam2 < 0) | (lam3 < 0), np.float32(0.0), v)
    else:
        v = np.where((lam2 > 0) | (lam3 > 0), np.float32(0.0), v)
    v = np.where(np.isnan(v), np.float32(0.0), v).astype(np.float32)
    return v, vx, vy, vz


def frangi3d(
    vol: np.ndarray,
    sigmas: Sequence[float],
    zdist: float,
    alpha: float = 0.5,
    beta: float = 0.5,
    c: float = 500.0,
    blackwhite: bool = False,
):
    """Host multi-scale Frangi; same contract as ops.frangi.frangi3d."""
    j = jmin = None
    out_vx = out_vy = out_vz = None
    for si, sig in enumerate(sigmas):
        v, vx, vy, vz = _vesselness3d_scale(
            vol, float(sig), float(zdist), alpha, beta, c, blackwhite
        )
        if si == 0:
            j = v
            jmin = np.float32(v.min())
            out_vx, out_vy, out_vz = (
                _quantize_dir(vx), _quantize_dir(vy), _quantize_dir(vz)
            )
        else:
            upd = v > j
            j = np.where(upd, v, j)
            out_vx = np.where(upd, _quantize_dir(vx), out_vx)
            out_vy = np.where(upd, _quantize_dir(vy), out_vy)
            out_vz = np.where(upd, _quantize_dir(vz), out_vz)
    jmax = np.float32(j.max())
    return j.astype(np.float32), jmin, jmax, out_vx, out_vy, out_vz


def frangi2d(
    img: np.ndarray,
    sigmas: Sequence[float],
    beta_one: float = 0.5,
    beta_two: float = 15.0,
    blackwhite: bool = False,
):
    """Host 2-D Frangi incl. the reference's eigen-axis swap
    (frangi.cpp:392-505, 444)."""
    beta_term = np.float32(2.0 * beta_one * beta_one)
    c_term = np.float32(2.0 * beta_two * beta_two)

    j = jmin = None
    out_vx = out_vy = None
    for si, sig in enumerate(sigmas):
        dyy, dxy, dxx = hessian2d(img, float(sig))
        tmp = np.sqrt((dxx - dyy) ** 2 + 4.0 * dxy * dxy).astype(np.float32)
        v2x = 2.0 * dxy
        v2y = dyy - dxx + tmp
        mag = np.sqrt(v2x * v2x + v2y * v2y)
        safe = mag > 0
        v2x = np.where(safe, v2x / np.where(safe, mag, 1.0), v2x)
        v2y = np.where(safe, v2y / np.where(safe, mag, 1.0), v2y)
        v1x, v1y = -v2y, v2x

        mu1 = 0.5 * (dxx + dyy + tmp)
        mu2 = 0.5 * (dxx + dyy - tmp)
        check = np.abs(mu1) < np.abs(mu2)
        lam1 = np.where(check, mu2, mu1)
        lam2 = np.where(check, mu1, mu2)
        vecx = np.where(check, v2x, v1x)
        vecy = np.where(check, v2y, v1y)

        lam1 = np.where(lam1 == 0, np.float32(_FLT_MIN), lam1)
        rb = (lam2 / lam1) ** 2
        s2 = lam1 * lam1 + lam2 * lam2
        v = np.exp(-rb / beta_term) * (1.0 - np.exp(-s2 / c_term))
        if blackwhite:
            v = np.where(lam1 < 0, np.float32(0.0), v)
        else:
            v = np.where(lam1 > 0, np.float32(0.0), v)
        v = v.astype(np.float32)

        vecn = np.sqrt(vecx * vecx + vecy * vecy)
        vecn = np.where(vecn > 0, vecn, 1.0)
        qx = _quantize_dir(vecx / vecn)
        qy = _quantize_dir(vecy / vecn)

        if si == 0:
            j = v
            jmin = np.float32(v.min())
            out_vx, out_vy = qx, qy
        else:
            upd = v > j
            j = np.where(upd, v, j)
            out_vx = np.where(upd, qx, out_vx)
            out_vy = np.where(upd, qy, out_vy)
    jmax = np.float32(j.max())
    out_vz = np.zeros_like(out_vx)
    return j.astype(np.float32), jmin, jmax, out_vx, out_vy, out_vz


def normalize_to_u8(j: np.ndarray, jmin, jmax) -> np.ndarray:
    """Port of ops.frangi.normalize_to_u8 (Advantra_plugin.cpp:2499-2512)."""
    span = np.float32(jmax) - np.float32(jmin)
    if abs(float(span)) <= _FLT_MIN:
        return np.zeros(j.shape, np.uint8)
    val = np.round(((j - np.float32(jmin)) / span) * 255.0)
    return np.clip(val, 0.0, 255.0).astype(np.uint8)
