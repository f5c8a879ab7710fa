"""Local template frame of the exact ZNCC.

Port of pnr_tpu/ops/zncc.py `local_frame` (tracker.cpp:1893-1917). The
template tables themselves (`ZnccTemplates`) come from ops/zncc_model.py,
a copy of the JAX package's.
"""

from __future__ import annotations

from typing import Tuple

import torch

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
