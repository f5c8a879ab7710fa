"""Halo exchange for sharded stencils over a mesh of devices.

Port of pnr_tpu/parallel/halo.py. JAX runs it inside `shard_map` and
moves the neighbours' slices with `lax.ppermute`; here a sharded volume
is a list of equal (Zl, Y, X) shard tensors, shard i on the mesh's
device i (parallel/sharded.py), and a shard's halo is copied to its
device from the shards that hold those planes (a copy between cards, or
none on a virtual mesh whose shards share one card). A halo deeper than
a shard takes planes from several shards, as JAX's several hops do, and
the result is the same: global planes, with the volume's edge planes
replicated beyond its borders (`halo_exchange_z`) or the window shifted
into the volume (`halo_exchange_z_aligned`).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch


def _rows(shards: Sequence[torch.Tensor], lo: int, hi: int, device) -> torch.Tensor:
    """Global planes [lo, hi) of the sharded volume, on `device`."""
    zl = int(shards[0].shape[0])
    parts = []
    for k in range(lo // zl, (hi - 1) // zl + 1):
        a, b = max(lo, k * zl) - k * zl, min(hi, (k + 1) * zl) - k * zl
        parts.append(shards[k][a:b].to(device))
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def halo_exchange_z(shards: Sequence[torch.Tensor], halo: int) -> List[torch.Tensor]:
    """Each (Zl, Y, X) shard padded with `halo` planes on both sides:
    (Zl + 2 halo, Y, X) on the shard's device, the volume's edge planes
    replicated beyond its borders (exact for clamp-equivalent operators:
    convolution with edge padding, min/max windows, clamped
    interpolation)."""
    n, zl = len(shards), int(shards[0].shape[0])
    z_tot = n * zl
    out = []
    for i, x in enumerate(shards):
        g0 = i * zl
        lo, hi = max(g0 - halo, 0), min(g0 + zl + halo, z_tot)
        body = _rows(shards, lo, hi, x.device)
        idx = torch.arange(g0 - halo, g0 + zl + halo, device=x.device).clamp_(0, z_tot - 1) - lo
        out.append(body.index_select(0, idx))
    return out


def halo_exchange_z_aligned(shards: Sequence[torch.Tensor], halo: int
                            ) -> List[Tuple[torch.Tensor, int]]:
    """Aligned-window halo exchange for border-sensitive stencils: per
    shard (slab, crop_off), the slab the global planes [w0, w0 + S) with
    S = Zl + 2 halo and w0 = clamp(g0 - halo, 0, Z - S), shifted into the
    volume at its borders so that every slab edge at a volume border is
    that border (the Hessian's one-sided differences then fire where the
    unsharded filter fires them); crop_off = g0 - w0 is where the shard's
    own planes start in the slab. When the volume is no deeper than a slab
    (or the mesh has one shard) every slab is the whole volume and
    crop_off = g0."""
    n, zl = len(shards), int(shards[0].shape[0])
    s_len, z_tot = zl + 2 * halo, n * zl
    out = []
    for i, x in enumerate(shards):
        g0 = i * zl
        if n == 1 or s_len >= z_tot:
            out.append((_rows(shards, 0, z_tot, x.device), g0))
            continue
        w0 = min(max(g0 - halo, 0), z_tot - s_len)
        out.append((_rows(shards, w0, w0 + s_len, x.device), g0 - w0))
    return out
