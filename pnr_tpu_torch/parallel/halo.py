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

On a multi-process mesh (parallel/multihost.py) another process's shard
is None here; the planes of it that this process's windows read arrive
through one `multihost.exchange`, each process sending, for each of its
shards, the rows any other process's windows need. The slabs of the
other processes' shards are None.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch


def _remote_rows(shards, windows, mesh) -> Dict[int, Tuple[torch.Tensor, int]]:
    """For a multi-process mesh: {k: (rows, r0)} for each other process's
    shard k, rows its local planes [r0, r0 + len(rows)) that the windows
    [lo, hi) of this process's shards read (host tensors)."""
    from pnr_tpu_torch.parallel.multihost import exchange

    zl = next(int(t.shape[0]) for t in shards if t is not None)
    need: Dict[int, Tuple[int, int]] = {}
    for i, (lo, hi) in enumerate(windows):
        for k in range(lo // zl, (hi - 1) // zl + 1):
            if mesh.ranks[k] != mesh.ranks[i]:
                a, b = max(lo, k * zl) - k * zl, min(hi, (k + 1) * zl) - k * zl
                cur = need.get(k, (a, b))
                need[k] = (min(cur[0], a), max(cur[1], b))
    mine = {k: (a, shards[k][a:b].cpu().numpy()) for k, (a, b) in need.items()
            if mesh.is_local(k)}
    got = {}
    for part in exchange(mine):
        got.update(part)
    return {k: (torch.from_numpy(rows), a) for k, (a, rows) in got.items()
            if not mesh.is_local(k)}


def _rows(shards: Sequence[Optional[torch.Tensor]], lo: int, hi: int, device,
          remote=None) -> torch.Tensor:
    """Global planes [lo, hi) of the sharded volume, on `device` (another
    process's planes from `remote`, `_remote_rows`'s)."""
    zl = next(int(t.shape[0]) for t in shards if t is not None)
    parts = []
    for k in range(lo // zl, (hi - 1) // zl + 1):
        a, b = max(lo, k * zl) - k * zl, min(hi, (k + 1) * zl) - k * zl
        if shards[k] is None:
            rows, r0 = remote[k]
            parts.append(rows[a - r0:b - r0].to(device))
        else:
            parts.append(shards[k][a:b].to(device))
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _windows(shards, mesh, window) -> Tuple[list, Optional[dict]]:
    """Each shard's window (lo, hi) of global planes, and the other
    processes' rows they read (None in one process)."""
    zl = next(int(t.shape[0]) for t in shards if t is not None)
    wins = [window(i * zl) for i in range(len(shards))]
    remote = None
    if mesh is not None and mesh.multiprocess:
        remote = _remote_rows(shards, wins, mesh)
    elif any(t is None for t in shards):
        raise ValueError("a sharded volume with another process's shards needs its mesh")
    return wins, remote


def halo_exchange_z(shards: Sequence[Optional[torch.Tensor]], halo: int,
                    mesh=None) -> List[Optional[torch.Tensor]]:
    """Each (Zl, Y, X) shard padded with `halo` planes on both sides:
    (Zl + 2 halo, Y, X) on the shard's device, the volume's edge planes
    replicated beyond its borders (exact for clamp-equivalent operators:
    convolution with edge padding, min/max windows, clamped
    interpolation). `mesh`: needed when the shards span processes."""
    n = len(shards)
    zl = next(int(t.shape[0]) for t in shards if t is not None)
    z_tot = n * zl
    wins, remote = _windows(shards, mesh,
                            lambda g0: (max(g0 - halo, 0), min(g0 + zl + halo, z_tot)))
    out = []
    for i, (x, (lo, hi)) in enumerate(zip(shards, wins)):
        if x is None:
            out.append(None)
            continue
        g0 = i * zl
        body = _rows(shards, lo, hi, x.device, remote)
        idx = torch.arange(g0 - halo, g0 + zl + halo, device=x.device).clamp_(0, z_tot - 1) - lo
        out.append(body.index_select(0, idx))
    return out


def halo_exchange_z_aligned(shards: Sequence[Optional[torch.Tensor]], halo: int, mesh=None
                            ) -> List[Optional[Tuple[torch.Tensor, int]]]:
    """Aligned-window halo exchange for border-sensitive stencils: per
    shard (slab, crop_off), the slab the global planes [w0, w0 + S) with
    S = Zl + 2 halo and w0 = clamp(g0 - halo, 0, Z - S), shifted into the
    volume at its borders so that every slab edge at a volume border is
    that border (the Hessian's one-sided differences then fire where the
    unsharded filter fires them); crop_off = g0 - w0 is where the shard's
    own planes start in the slab. When the volume is no deeper than a slab
    (or the mesh has one shard) every slab is the whole volume and
    crop_off = g0. `mesh`: needed when the shards span processes (the
    other processes' entries are then None)."""
    n = len(shards)
    zl = next(int(t.shape[0]) for t in shards if t is not None)
    s_len, z_tot = zl + 2 * halo, n * zl

    def window(g0):
        if n == 1 or s_len >= z_tot:
            return 0, z_tot
        w0 = min(max(g0 - halo, 0), z_tot - s_len)
        return w0, w0 + s_len

    wins, remote = _windows(shards, mesh, window)
    out = []
    for i, (x, (lo, hi)) in enumerate(zip(shards, wins)):
        out.append(None if x is None else (_rows(shards, lo, hi, x.device, remote), i * zl - lo))
    return out
