"""Zero-mean NCC of trilinearly sampled points against cylinder templates.

Port of pnr_tpu/ops/zncc.py (parity target `Tracker::znccBBB`,
pnr-vaa3d/tracker.cpp:1891-1964): `local_frame` (tracker.cpp:1893-1917),
and the plain batched likelihood `zncc_batch`/`make_zncc_fn` for
scattered (position, direction) queries, as torch ops. JAX computes these
in XLA, not in a Pallas kernel; the tracer's and the seed scorer's hot
paths evaluate the same sums through K2 (ops/zncc_exact.py). The template
tables themselves (`ZnccTemplates`) come from ops/zncc_model.py, a copy
of the JAX package's.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from pnr_tpu_torch.ops.interp import trilinear
from pnr_tpu_torch.ops.zncc_model import ZnccTemplates

_FLT_MIN = 1.175494e-38


def local_frame(
    vx: torch.Tensor, vy: torch.Tensor, vz: torch.Tensor, is2d: bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(u, w) orthogonal frame for direction v, each (..., 3).

    The reference's w is not a standard cross product (its y component
    has a flipped sign); it is reproduced verbatim."""
    nrm = torch.sqrt(vx * vx + vy * vy)
    planar = nrm > 1e-4
    safe = torch.where(planar, nrm, torch.ones_like(nrm))
    sg = torch.where(vy < 0, -torch.ones_like(vy), torch.ones_like(vy))
    ux = torch.where(planar, sg * (vy / safe), torch.ones_like(vy))
    uy = torch.where(planar, -sg * (vx / safe), torch.zeros_like(vx))
    uz = torch.zeros_like(ux)
    if is2d:
        wx = wy = wz = torch.zeros_like(ux)
    else:
        wx = uy * vz - uz * vy
        wy = -ux * vz + uz * vx
        wz = ux * vy - uy * vx
    return torch.stack([ux, uy, uz], dim=-1), torch.stack([wx, wy, wz], dim=-1)


def zncc_batch(img, pos, dirs, offs, wgt, mask, cnt, avg, corrc, sigmas, is2d: bool):
    """Batched znccBBB: max correlation over sigmas and the argmax sigma.

    img: (Z, Y, X) volume (any dtype, sampled as float32); pos (B, 3)
    query positions (x, y, z); dirs (B, 3) unit directions; the template
    arrays as `ZnccTemplates` builds them, as float32 tensors on img's
    device. Returns (corr (B,), sig (B,))."""
    vx, vy, vz = dirs[:, 0], dirs[:, 1], dirs[:, 2]
    u, w = local_frame(vx, vy, vz, is2d)
    neg_v = -dirs  # the template's v axis points against the direction (tracker.cpp:1931)
    b = pos.shape[0]
    best_corr = torch.full((b,), float("-inf"), dtype=torch.float32, device=pos.device)
    best_sig = torch.ones((b,), dtype=torch.float32, device=pos.device)
    vol = img[None]
    for si in range(len(sigmas)):
        o, m, g = offs[si], mask[si], wgt[si]
        world = (pos[:, None, :] + o[None, :, 0:1] * neg_v[:, None, :]
                 + o[None, :, 1:2] * u[:, None, :] + o[None, :, 2:3] * w[:, None, :])
        vals = trilinear(vol, world[None, ..., 0], world[None, ..., 1], world[None, ..., 2])[0]
        vals = vals * m[None, :]
        ag = vals.sum(dim=1) / cnt[si]
        dv = (vals - ag[:, None]) * m[None, :]
        dw = (g - avg[si]) * m
        corra = (dv * dw[None, :]).sum(dim=1)
        corrb = (dv * dv).sum(dim=1)
        denom = corrb * corrc[si]
        corr = torch.where(denom > _FLT_MIN, corra / torch.sqrt(torch.clamp(denom, min=_FLT_MIN)),
                           torch.zeros_like(denom))
        take = corr > best_corr
        best_corr = torch.where(take, corr, best_corr)
        best_sig = torch.where(take, torch.full_like(best_sig, float(sigmas[si])), best_sig)
    return best_corr, best_sig


#: Queries a chunk: bounds the (B, K) sample temporaries of one call
#: (JAX's fixed compiled batch).
ZNCC_CHUNK = 512


def make_zncc_fn(templates: ZnccTemplates, chunk: int = ZNCC_CHUNK):
    """Bind the template constants into (img, pos, dirs) -> (corr, sig)
    on img's device, `chunk` queries at a time."""

    def fn(img: torch.Tensor, pos, dirs):
        dev = img.device

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=dev)

        pos = torch.as_tensor(pos, dtype=torch.float32, device=dev)
        dirs = torch.as_tensor(dirs, dtype=torch.float32, device=dev)
        tabs = tuple(t(getattr(templates, k)) for k in ("offs", "wgt", "mask", "cnt", "avg", "corrc"))
        outs = [zncc_batch(img, pos[i:i + chunk], dirs[i:i + chunk], *tabs,
                           templates.sigmas, templates.is2d)
                for i in range(0, max(1, pos.shape[0]), chunk)]
        return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])

    return fn
