"""Host tube-ZNCC: planar maps + clamped trilinear + correlation.

A copy of pnr_tpu/hostpath/tube.py, imports aside.

NumPy port of the tube likelihood (`pnr_tpu.ops.zncc_fast`, itself the
TPU redesign of znccBBB, pnr-vaa3d/tracker.cpp:1891-1964): identical
model constants (TubeZnccModel is already host numpy), separable map
convolutions via scipy, and the same clamped trilinear sampling as
`ops.interp.trilinear` (tracker.cpp:2138-2215). Given identical maps
the query math matches the device gather formulation to f32
reassociation ulps; the model constants and sample lattice are shared
EXACTLY (imported from ops.zncc_fast — jax-free modules only).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
from scipy.ndimage import correlate1d, uniform_filter1d

_FLT_MIN = 1.175494e-38


def _conv1d(vol, k, axis):
    return correlate1d(
        vol.astype(np.float32, copy=False), k, axis=axis, mode="nearest"
    )


def _box1d(vol, half, axis):
    # match conv1d_along_axis with an all-ones kernel (edge replicate):
    # uniform_filter1d(size) * size, 'nearest' mode
    size = 2 * half + 1
    return (
        uniform_filter1d(
            vol.astype(np.float32, copy=False), size, axis=axis, mode="nearest"
        )
        * np.float32(size)
    )


def build_tube_maps(img: np.ndarray, model) -> np.ndarray:
    """(3S, Z, Y, X) planar map stack (ops.zncc_fast.build_tube_maps)."""
    f = img.astype(np.float32)
    f2 = f * f
    is2d = model.is2d
    per = []
    for i, sig in enumerate(model.sigmas):
        k1 = model.gauss_kernels[i]
        m1 = _conv1d(f, k1, 2)
        m1 = _conv1d(m1, k1, 1)
        if not is2d:
            m1 = _conv1d(m1, k1, 0)
        bh = model.box_half[i]
        m2 = _box1d(_box1d(f, bh, 2), bh, 1)
        m3 = _box1d(_box1d(f2, bh, 2), bh, 1)
        if not is2d:
            m2 = _box1d(m2, bh, 0)
            m3 = _box1d(m3, bh, 0)
        per += [m1, m2, m3]
    return np.stack(per)


def trilinear(vol: np.ndarray, x, y, z) -> np.ndarray:
    """Clamped trilinear sampling, ops.interp.trilinear semantics."""
    l, h, w = vol.shape
    v = vol.astype(np.float32, copy=False)
    x, y, z = np.broadcast_arrays(x, y, z)
    shape = x.shape
    x = x.reshape(-1).astype(np.float32)
    y = y.reshape(-1).astype(np.float32)
    z = z.reshape(-1).astype(np.float32)

    xc = np.clip(x, 0.0, np.float32(w - 1.001))
    x1 = np.floor(xc).astype(np.int64)
    xf = xc - x1
    yc = np.clip(y, 0.0, np.float32(h - 1.001))
    y1 = np.floor(yc).astype(np.int64)
    yf = yc - y1

    if l == 1:
        v2 = v[0]
        y2 = np.minimum(y1 + 1, h - 1)
        x2 = np.minimum(x1 + 1, w - 1)
        out = (1 - yf) * ((1 - xf) * v2[y1, x1] + xf * v2[y1, x2]) + yf * (
            (1 - xf) * v2[y2, x1] + xf * v2[y2, x2]
        )
        return out.reshape(shape).astype(np.float32)

    zc = np.clip(z, 0.0, np.float32(l - 1.001))
    z1 = np.floor(zc).astype(np.int64)
    zf = zc - z1
    z2 = z1 + 1
    y2 = y1 + 1
    x2 = x1 + 1
    p1 = (1 - yf) * ((1 - xf) * v[z1, y1, x1] + xf * v[z1, y1, x2]) + yf * (
        (1 - xf) * v[z1, y2, x1] + xf * v[z1, y2, x2]
    )
    p2 = (1 - yf) * ((1 - xf) * v[z2, y1, x1] + xf * v[z2, y1, x2]) + yf * (
        (1 - xf) * v[z2, y2, x1] + xf * v[z2, y2, x2]
    )
    out = (1 - zf) * p1 + zf * p2
    return out.reshape(shape).astype(np.float32)


def make_tube_zncc_fn(model):
    """(maps, pos, dirs) -> (corr, sig): NumPy mirror of
    ops.zncc_fast.make_tube_zncc_fn (same model, same v grids)."""
    sigmas = model.sigmas
    v_grids = [np.asarray(v, np.float32) for v in model.v_grids]
    a1, a2 = model.alpha1, model.alpha2
    gbar, ntot, corrc = model.gbar, model.n, model.corrc

    def fn(maps, pos, dirs):
        pos = np.asarray(pos, np.float32)
        dirs = np.asarray(dirs, np.float32)
        best_corr = np.full(pos.shape[0], -np.inf, np.float32)
        best_sig = np.ones(pos.shape[0], np.float32)
        for si in range(len(sigmas)):
            vv = v_grids[si]
            pts = pos[:, None, :] + vv[None, :, None] * dirs[:, None, :]
            x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
            s1 = trilinear(maps[3 * si], x, y, z).sum(axis=1) * a1[si]
            s2 = trilinear(maps[3 * si + 1], x, y, z).sum(axis=1) * a2[si]
            s3 = trilinear(maps[3 * si + 2], x, y, z).sum(axis=1) * a2[si]
            corra = s1 - gbar[si] * s2
            corrb = np.maximum(s3 - (s2 * s2) / ntot[si], np.float32(0.0))
            denom = corrb * corrc[si]
            with np.errstate(invalid="ignore", divide="ignore"):
                corr = np.where(
                    denom > _FLT_MIN,
                    corra / np.sqrt(np.maximum(denom, np.float32(_FLT_MIN))),
                    np.float32(0.0),
                ).astype(np.float32)
            take = corr > best_corr
            best_corr = np.where(take, corr, best_corr)
            best_sig = np.where(take, np.float32(sigmas[si]), best_sig)
        return best_corr, best_sig

    return fn
