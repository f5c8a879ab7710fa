"""Alternate cross-section seed extractor (superseded path).

Port of pnr_tpu/seeds/alt.py (parity target `SeedExtractor::extract3d/
extract2d`, pnr-vaa3d/seed.cpp:137-326, with its per-scale neighbourhood
offsets built in the constructor, seed.cpp:40-63). This path is
superseded by the MaximumFinder-based `extractSeeds` in the live
reference (component 11, SURVEY.md §2) and no pipeline calls it: a voxel
is a seed candidate when its vesselness exceeds a threshold, none of the
offsets on the cross-section disc at its scale has higher vesselness,
the mean vesselness drop (score) exceeds seed_score_min, and the ZNCC at
the voxel exceeds seed_corr_min. Seeds are sorted by score descending.

`frangi3d_with_scale` runs the unfused filter's per-scale vesselness on
the routed Hessian (K4 and K3 on a card); the neighbourhood test samples
J8 with `trilinear` and the ZNCC filter runs `make_zncc_fn`, on the
volume's device. The host code between them is the JAX package's NumPy.

Note: this path uses the SeedExtractor's own orthogonal-frame
convention (seed.cpp:333-352), which differs in sign from the
tracker's (SURVEY.md §2a quirk) — reproduced verbatim.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

from pnr_tpu_torch.ops.frangi import _vesselness3d_scale, normalize_to_u8
from pnr_tpu_torch.ops.hessian import hessian3d
from pnr_tpu_torch.ops.interp import trilinear
from pnr_tpu_torch.ops.zncc import make_zncc_fn
from pnr_tpu_torch.ops.zncc_model import ZnccTemplates


def frangi3d_with_scale(vol, sigmas, zdist, alpha=0.5, beta=0.5, c=500.0):
    """Multi-scale Frangi of a (Z, Y, X) tensor that also returns the
    float directions and the argmax scale index per voxel (needed by the
    alt extractor): (J, Vx, Vy, Vz float32, scale uint8). A later scale
    takes a voxel only where its response is strictly larger, so J is
    `frangi3d`'s."""
    j = fvx = fvy = fvz = sc = None
    for si, sig in enumerate(sigmas):
        v, vx, vy, vz = _vesselness3d_scale(hessian3d, vol, float(sig), float(zdist),
                                            alpha, beta, c, False)
        if si == 0:
            j, fvx, fvy, fvz = v, vx, vy, vz
            sc = torch.zeros(v.shape, dtype=torch.uint8, device=v.device)
        else:
            upd = v > j
            j = torch.where(upd, v, j)
            fvx = torch.where(upd, vx, fvx)
            fvy = torch.where(upd, vy, fvy)
            fvz = torch.where(upd, vz, fvz)
            sc = torch.where(upd, torch.full_like(sc, si), sc)
    return j, fvx, fvy, fvz, sc


def _suwv_offsets(sigmas: Sequence[float], sig2r: float) -> list:
    """Per-scale neighbourhood offsets as (u-axis, w-axis, V-axis)
    multipliers (seed.cpp:52-61).

    Reference quirk reproduced verbatim: `Puwv`'s constructor is
    `(u1, w1, v1)` (seed.h:24) but the build loop calls `Puwv(u, v, w)`
    (seed.cpp:57), so the loop's `v` (+-1) lands on the W field and the
    loop's `w` (+-Ruw) on the V field — the consumer
    (`xN = u*ux + w*wx + v*Vx`, seed.cpp:177-179) therefore spreads the
    +-Ruw disc extent over the (u, VESSEL-AXIS) plane with only +-1
    along the second orthogonal, not over the cross-section the comment
    claims."""
    out = []
    for sig in sigmas:
        ruw = int(math.ceil(sig2r * sig))
        rv = 1
        offs = []
        for u in range(-ruw, ruw + 1):
            for w in range(-ruw, ruw + 1):
                for v in range(-rv, rv + 1):
                    if 0 < u * u + w * w <= ruw * ruw:
                        offs.append((u, v, w))  # (u->u, v->W, w->V): the ctor swap
        out.append(np.asarray(offs, np.float32))
    return out


def _seed_orthogonals(vx, vy, vz):
    """SeedExtractor::orthogonals 3-D frame (seed.cpp:333-352), verbatim
    including its sign convention."""
    n = np.sqrt(vx * vx + vy * vy)
    planar = n > 1e-5
    safe = np.where(planar, n, 1.0)
    ux = np.where(planar, vy / safe, 1.0)
    uy = np.where(planar, -vx / safe, 0.0)
    uz = np.zeros_like(ux)
    wx = uy * vz - uz * vy
    wy = ux * vz - uz * vx
    wz = ux * vy - uy * vx
    return ux, uy, uz, wx, wy, wz


def extract3d_alt(
    vol: np.ndarray,
    cfg,
    j8_threshold: int = 0,
    seed_score_min: float = 0.0,
    seed_corr_min: float = 0.5,
    smap: np.ndarray | None = None,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Cross-section local-maxima seeds; returns (pos, dirs, score, corr)
    sorted by score descending. The filter, the J8 samples and the ZNCC
    run on `device`."""
    img = torch.from_numpy(np.ascontiguousarray(vol)).to(device)
    j, fvx, fvy, fvz, sc = frangi3d_with_scale(
        img, cfg.sigmas, cfg.zdist, cfg.frangi_alpha, cfg.frangi_beta, cfg.frangi_c
    )
    j8_dev = normalize_to_u8(j, j.min(), j.max())
    j8 = j8_dev.cpu().numpy()
    fvx = fvx.cpu().numpy()
    fvy = fvy.cpu().numpy()
    fvz = fvz.cpu().numpy()
    sc_np = sc.cpu().numpy()
    j = None

    cand = j8 > j8_threshold
    if smap is not None:
        cand &= smap == 0
    zz, yy, xx = np.nonzero(cand)
    if len(xx) == 0:
        empty = np.zeros((0,), np.float32)
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32), empty, empty

    offs_by_scale = _suwv_offsets(cfg.sigmas, cfg.sig2radius)

    def dev32(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(img.device)[None]

    pos_list, dir_list, score_list = [], [], []
    for si in range(len(cfg.sigmas)):
        m = sc_np[zz, yy, xx] == si
        if not m.any():
            continue
        cz, cy, cx = zz[m], yy[m], xx[m]
        vx = fvx[cz, cy, cx]
        vy = fvy[cz, cy, cx]
        vz = fvz[cz, cy, cx]
        ux, uy, uz, wx, wy, wz = _seed_orthogonals(vx, vy, vz)
        offs = offs_by_scale[si]  # (K, 3) as (u, w, v)
        sx = (
            cx[:, None]
            + offs[None, :, 0] * ux[:, None]
            + offs[None, :, 1] * wx[:, None]
            + offs[None, :, 2] * vx[:, None]
        )
        sy = (
            cy[:, None]
            + offs[None, :, 0] * uy[:, None]
            + offs[None, :, 1] * wy[:, None]
            + offs[None, :, 2] * vy[:, None]
        )
        sz = (
            cz[:, None]
            + offs[None, :, 0] * uz[:, None]
            + offs[None, :, 1] * wz[:, None]
            + offs[None, :, 2] * vz[:, None]
        )
        nb = trilinear(j8_dev[None], dev32(sx), dev32(sy), dev32(sz))[0].cpu().numpy()
        center = j8[cz, cy, cx].astype(np.float64)
        is_max = ~(nb > center[:, None]).any(axis=1)
        score = (center[:, None] - nb).sum(axis=1) / offs.shape[0]
        keep = is_max & (score > 1e-38) & (score > seed_score_min)
        if not keep.any():
            continue
        pos_list.append(
            np.stack([cx[keep], cy[keep], cz[keep]], axis=-1).astype(np.float32)
        )
        dir_list.append(
            np.stack([vx[keep], vy[keep], vz[keep]], axis=-1).astype(np.float32)
        )
        score_list.append(score[keep].astype(np.float32))

    if not pos_list:
        empty = np.zeros((0,), np.float32)
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32), empty, empty

    pos = np.concatenate(pos_list)
    dirs = np.concatenate(dir_list)
    score = np.concatenate(score_list)

    # ZNCC filter (seed.cpp:192-199) via the batched template correlation
    zfn = make_zncc_fn(ZnccTemplates(cfg.sigmas, is2d=False))
    corr, _ = zfn(img, pos, dirs)
    corr = corr.cpu().numpy()
    keep = corr > seed_corr_min
    pos, dirs, score, corr = pos[keep], dirs[keep], score[keep], corr[keep]

    order = np.argsort(-score, kind="stable")
    return pos[order], dirs[order], score[order], corr[order]
