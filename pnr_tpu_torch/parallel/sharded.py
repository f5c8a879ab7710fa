"""Sharded pipeline stages over a 1-D mesh of devices.

Port of pnr_tpu/parallel/sharded.py for one process. JAX shards over a
`jax.sharding.Mesh` inside `shard_map`, its collectives riding the chips'
links; here a mesh is a tuple of torch devices (`Mesh`), a sharded volume
a list of equal Z slabs, slab i on device i (`shard_volume`), each shard's
work runs on its device, and what JAX moves with `ppermute` and
`pmin`/`pmax` is copied between the devices (parallel/halo.py). Shard i
is on `cuda:i` (`make_mesh`); a virtual mesh of n shards on one card is
`Mesh((torch.device("cuda:0"),) * n)`, the counterpart of the JAX tests'
8-device CPU mesh.

The filter runs the unfused `frangi3d` (K4 and K3 on a card) on each
shard's aligned halo slab, or the tiled engines where their planned peak
is the lower (`slab_filter_route`), and is bitwise the monolithic
filter: J, Vx, Vy, Vz on every plane, and Jmin (the first scale's min)
and Jmax as global reductions over the shards.

The library steps JAX builds over the mesh are here too, for callers
that drive a mesh one step at a time (no pipeline calls them):
`seeds_sharded` (the device flood on each shard's slab, the strongest
seeds of each), `build_local_trace_step` (shard-local tracing, a trace
ending where it leaves its slab) and `build_sharded_step` (filter, J8,
seeds and one handed-off trace wave in one call).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from pnr_tpu_torch.ops.frangi import frangi2d, frangi3d, normalize_to_u8
from pnr_tpu_torch.ops.frangi_blocked import (
    frangi2d_tiled,
    frangi3d_blocked,
    frangi3d_tiled,
    pick_blocks,
    pick_blocks_2d,
)
from pnr_tpu_torch.parallel.halo import halo_exchange_z_aligned
from pnr_tpu_torch.seeds.extract import max_points_device
from pnr_tpu_torch.utils.runtime import require_cuda

Sharded = List[torch.Tensor]  # one tensor per shard, on the shard's device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: shard i runs on devices[i] (a device may repeat). A mesh
    over several processes (`multihost.make_global_mesh`) records the rank
    that owns each shard in `ranks` and this process's in `rank`; without
    `ranks` every shard is this process's."""

    devices: Tuple[torch.device, ...]
    axis: str = "z"
    ranks: Optional[Tuple[int, ...]] = None
    rank: int = 0

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def multiprocess(self) -> bool:
        return self.ranks is not None and len(set(self.ranks)) > 1

    def is_local(self, i: int) -> bool:
        return self.ranks is None or self.ranks[i] == self.rank

    @property
    def local_devices(self) -> Tuple[torch.device, ...]:
        """This process's shard devices, each once, in shard order."""
        return tuple(dict.fromkeys(d for i, d in enumerate(self.devices) if self.is_local(i)))


def make_mesh(n_devices: int = None, axis: str = "z", device="cuda") -> Mesh:
    """1-D mesh over the first n_devices cards (`cuda:0` ...), or of
    n_devices CPU shards with device="cpu". Fails loudly, never truncating
    the mesh nor placing two shards on one card, when fewer cards are
    present: a silently smaller mesh would void every multi-device
    correctness signal downstream."""
    dev = require_cuda(device)
    if dev.type == "cpu":
        return Mesh((dev,) * (n_devices or 1), axis)
    have = torch.cuda.device_count()
    n = have if n_devices is None else int(n_devices)
    if have < n:
        raise ValueError(
            f"make_mesh({n}): only {have} cuda device(s) available; for a virtual mesh of {n} "
            f"shards on one card build Mesh((torch.device('cuda:0'),) * {n})"
        )
    return Mesh(tuple(torch.device("cuda", i) for i in range(n)), axis)


def on(device: torch.device):
    """Run the enclosed work on `device`: the CUDA wrappers launch onto the
    current device's stream, so work for cuda:i runs under
    torch.cuda.device(i)."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def shard_volume(vol: np.ndarray, mesh: Mesh) -> Sharded:
    """A (Z, Y, X) volume as Z slabs, slab i on the mesh's device i (Z must
    divide evenly; the pipeline pads it first). On a multi-process mesh
    only this process's slabs are read (`vol[a:b]`) and placed; the
    others' are None."""
    n = mesh.size
    if vol.shape[0] % n:
        raise ValueError(f"mesh size ({n}) must divide Z={vol.shape[0]}")
    zl = vol.shape[0] // n
    return [torch.from_numpy(np.ascontiguousarray(vol[i * zl:(i + 1) * zl])).to(d)
            if mesh.is_local(i) else None for i, d in enumerate(mesh.devices)]


def shard_len(shards: Sharded) -> int:
    """The planes (rows) a shard holds, read from this process's first."""
    return int(next(t for t in shards if t is not None).shape[0])


def frangi_halo(sigmas: Sequence[float], zdist: float) -> int:
    """Ghost slices needed in Z: Gaussian z-kernel + two first-difference passes."""
    return int(math.ceil(3.0 * max(sigmas) / zdist)) + 2


def frangi2d_halo(sigmas: Sequence[float]) -> int:
    """Ghost rows needed in Y: Gaussian kernel + two first-difference passes."""
    return int(math.ceil(3.0 * max(sigmas))) + 2


@dataclasses.dataclass(frozen=True)
class SlabRoute:
    """The filter route of one halo slab: the monolithic unfused filter
    (`tiled` False), `frangi3d_tiled` at `blocks` (bz, by), or
    `frangi3d_blocked` (`tiled` True, `blocks` None); `peak_bytes` is its
    planned device peak, the slab included."""

    tiled: bool
    blocks: Optional[Tuple[int, int]]
    peak_bytes: int


def slab_filter_route(slab_shape, sigmas, zdist, tiled: Optional[bool] = None) -> SlabRoute:
    """The route with the lower planned peak for a (Z, Y, X) halo slab, the
    one rule of `frangi3d_sharded` and `plan.plan_sharded`: the monolithic
    filter at UNFUSED_PEAK_BYTES_PER_VOXEL a voxel, or the tiled engines'
    outputs and normalisation (FUSED_PEAK_BYTES_PER_VOXEL a voxel) plus one
    tile at the unfused peak (a `TILE_VOX_BUDGET`-voxel tile, or a 32-plane
    block and its halo when `pick_blocks` finds no tile). With the 32-Mvox
    tile the two cross near 35.7 Mvox. The monolithic filter also stays
    under the single-device cap UNFUSED_MAX_VOXELS. Both routes are bitwise
    the same filter, so only memory and speed depend on the choice.
    `tiled` forces it (the planner's `blocked_frangi`)."""
    from pnr_tpu_torch.pipeline import reconstruct as rc  # its caps, read at call time

    z, y, x = (int(d) for d in slab_shape)
    n = z * y * x
    mono = rc.UNFUSED_PEAK_BYTES_PER_VOXEL * n
    blocks = pick_blocks((z, y, x), tuple(sigmas), zdist, rc.TILE_VOX_BUDGET)
    tile = rc.TILE_VOX_BUDGET if blocks is not None else \
        min(32 + 2 * frangi_halo(sigmas, zdist), z) * y * x
    tiles = rc.FUSED_PEAK_BYTES_PER_VOXEL * n + rc.UNFUSED_PEAK_BYTES_PER_VOXEL * tile
    if tiled is None:
        tiled = n > rc.UNFUSED_MAX_VOXELS or tiles < mono
    return SlabRoute(True, blocks, tiles) if tiled else SlabRoute(False, None, mono)


def _global(mesh: Mesh, jmins, jmaxs):
    """The global Jmin and Jmax, 0-d tensors on this process's first shard
    device: the shards' own reduced here, then, on a multi-process mesh,
    the processes' through `multihost.exchange` (min and max are exact, so
    the order does not matter)."""
    d0 = mesh.local_devices[0]
    jmin = torch.stack([t.to(d0) for t in jmins]).min()
    jmax = torch.stack([t.to(d0) for t in jmaxs]).max()
    if mesh.multiprocess:
        from pnr_tpu_torch.parallel.multihost import exchange

        got = np.asarray(exchange((jmin.cpu().numpy(), jmax.cpu().numpy())))
        jmin = torch.from_numpy(np.asarray(got[:, 0].min())).to(d0)
        jmax = torch.from_numpy(np.asarray(got[:, 1].max())).to(d0)
    return jmin, jmax


def frangi3d_sharded(shards: Sharded, sigmas: Tuple[float, ...], zdist: float, mesh: Mesh,
                     alpha: float = 0.5, beta: float = 0.5, c: float = 500.0):
    """Multi-scale Frangi over a Z-sharded volume; returns (J, Jmin, Jmax,
    Vx, Vy, Vz) with J and the directions sharded and Jmin/Jmax global.

    Bitwise the unsharded `frangi3d`: each shard filters its aligned halo
    slab (`halo_exchange_z_aligned`), whose edges at the volume's borders
    are those borders, and keeps its own planes; Jmin is the min of the
    first scale's response over the shards' own planes (the monolithic
    filter's running min), Jmax the max of J. A slab whose tiled route
    plans the lower peak (`slab_filter_route`) streams through the tiled
    engines, which are bitwise the monolithic filter."""
    halo = frangi_halo(sigmas, zdist)
    args = (sigmas, zdist, alpha, beta, c)
    js, jmins, jmaxs, vxs, vys, vzs = [], [], [], [], [], []
    for dev, v, got in zip(mesh.devices, shards, halo_exchange_z_aligned(shards, halo, mesh)):
        if v is None:  # another process's shard
            for a in (js, vxs, vys, vzs):
                a.append(None)
            continue
        slab, off = got
        zl = int(v.shape[0])
        rows = (off, off + zl)
        with on(dev):
            route = slab_filter_route(slab.shape, sigmas, zdist)
            if route.tiled:
                if route.blocks is not None:
                    j, jmin, _, vx, vy, vz = frangi3d_tiled(
                        slab, *args, block_z=route.blocks[0], block_y=route.blocks[1],
                        jmin_rows=rows)
                else:
                    j, jmin, _, vx, vy, vz = frangi3d_blocked(slab, *args, jmin_rows=rows)
            else:
                j, _, _, vx, vy, vz, v1 = frangi3d(slab, *args, keep_first_scale=True)
                jmin = v1[off:off + zl].min()
                v1 = None
            j, vx, vy, vz = (a[off:off + zl].contiguous() for a in (j, vx, vy, vz))
            jmaxs.append(j.max())
        jmins.append(jmin)
        js.append(j)
        vxs.append(vx)
        vys.append(vy)
        vzs.append(vz)
        slab = None
    jmin, jmax = _global(mesh, jmins, jmaxs)
    return js, jmin, jmax, vxs, vys, vzs


def frangi2d_sharded(shards_t: Sharded, sigmas: Tuple[float, ...], mesh: Mesh,
                     beta_one: float = 0.5, beta_two: float = 15.0):
    """Multi-scale 2-D Frangi over a Y-sharded one-plane image: `shards_t`
    holds the transposed (Y, 1, X) representation of a (1, Y, X) stack,
    sharded over Y, and the outputs stay in that layout; Jmin/Jmax are
    global. Bitwise the unsharded `frangi2d` (frangi.cpp:392-505) on the
    image; a slab over the single-device pipeline's FRANGI2D_TILED_PIXELS
    runs `frangi2d_tiled`."""
    from pnr_tpu_torch.pipeline import reconstruct

    halo = frangi2d_halo(sigmas)
    js, jmins, jmaxs, vxs, vys, vzs = [], [], [], [], [], []
    for dev, v, got in zip(mesh.devices, shards_t,
                           halo_exchange_z_aligned(shards_t, halo, mesh)):
        if v is None:  # another process's shard
            for a in (js, vxs, vys, vzs):
                a.append(None)
            continue
        slab, off = got
        yl = int(v.shape[0])
        img = slab[:, 0, :].contiguous()
        with on(dev):
            if img.numel() > reconstruct.FRANGI2D_TILED_PIXELS:
                by, bx = pick_blocks_2d(tuple(img.shape), tuple(sigmas))
                j, jmin, _, vx, vy = frangi2d_tiled(img, tuple(sigmas), beta_one, beta_two,
                                                    block_y=by, block_x=bx,
                                                    jmin_rows=(off, off + yl))
                vz = torch.zeros_like(vx)
            else:
                j, _, _, vx, vy, vz, v1 = frangi2d(img, tuple(sigmas), beta_one, beta_two,
                                                   keep_first_scale=True)
                jmin = v1[off:off + yl].min()
                v1 = None
            j, vx, vy, vz = (a[off:off + yl, None, :].contiguous() for a in (j, vx, vy, vz))
            jmaxs.append(j.max())
        jmins.append(jmin)
        js.append(j)
        vxs.append(vx)
        vys.append(vy)
        vzs.append(vz)
        slab = img = None
    jmin, jmax = _global(mesh, jmins, jmaxs)
    return js, jmin, jmax, vxs, vys, vzs


def normalize_to_u8_sharded(j: Sharded, jmin: torch.Tensor, jmax: torch.Tensor) -> Sharded:
    """J8 quantization of a sharded J with global Jmin/Jmax: the one
    normalization rule (ops/frangi.normalize_to_u8) on each shard."""
    out = []
    for t in j:
        if t is None:  # another process's shard
            out.append(None)
            continue
        with on(t.device):
            out.append(normalize_to_u8(t, jmin.to(t.device), jmax.to(t.device)))
    return out


def assign_seeds_to_shards(pos: np.ndarray, dirs: np.ndarray, z_total: int, n_shards: int,
                           seeds_per_shard: int):
    """Bucket seeds by the Z-slab containing them, padded/truncated to a
    fixed count per shard. Returns (pos (n_shards*k, 3), dirs, valid mask)."""
    zl = z_total // n_shards
    out_p = np.zeros((n_shards * seeds_per_shard, 3), np.float32)
    out_d = np.zeros((n_shards * seeds_per_shard, 3), np.float32)
    out_d[:, 0] = 1.0
    valid = np.zeros(n_shards * seeds_per_shard, bool)
    for s in range(n_shards):
        lo, hi = s * zl, (s + 1) * zl if s < n_shards - 1 else z_total
        m = (pos[:, 2] >= lo) & (pos[:, 2] < hi)
        sel = np.nonzero(m)[0][:seeds_per_shard]
        k = len(sel)
        out_p[s * seeds_per_shard: s * seeds_per_shard + k] = pos[sel]
        out_d[s * seeds_per_shard: s * seeds_per_shard + k] = dirs[sel]
        valid[s * seeds_per_shard: s * seeds_per_shard + k] = True
    return out_p, out_d, valid


def _gather_shards(mesh: Mesh, mine: dict) -> list:
    """Per-shard host results in shard order: this process's from `mine`
    ({shard: result}), the other processes' through one `exchange`."""
    if mesh.multiprocess:
        from pnr_tpu_torch.parallel.multihost import exchange

        for part in exchange(dict(mine)):
            mine.update(part)
    return [mine[s] for s in range(mesh.size)]


def seeds_sharded(j8: Sharded, vx_u8: Sharded, vy_u8: Sharded, vz_u8: Sharded,
                  tolerance: float, mesh: Mesh, cap_per_shard: int):
    """MaximumFinder seed extraction over a Z-sharded J8 volume.

    The tolerance flood is strictly per z-slice (seed.cpp:574), so the
    device flood (`max_points_device`) on each shard's slab, on its
    device, is exact with no halo. Per shard the strongest
    `cap_per_shard` MAX_POINTs by J8 value are kept, equal values in
    ascending voxel order (JAX's `lax.top_k`; a stable descending sort
    here, since `torch.topk` promises no order among ties), with their
    decoded Frangi directions; `found` is the shard's true seed count, so
    a caller can see the cap overflow.

    Returns host arrays (pos (n*cap, 3) volume xyz, dirs (n*cap, 3),
    valid (n*cap,), found (n,)), shard s in rows [s*cap, (s+1)*cap)."""
    k = int(cap_per_shard)
    mine = {}
    for s, (t, ax, ay, az) in enumerate(zip(j8, vx_u8, vy_u8, vz_u8)):
        if t is None:  # another process's shard
            continue
        zl, h, w = t.shape
        with on(t.device):
            mask = max_points_device(t, float(tolerance))
            score = torch.where(mask, t.to(torch.int32) + 1, 0).reshape(-1)
            vals, idx = torch.sort(score, descending=True, stable=True)
            vals, idx = vals[:k], idx[:k]
            u = torch.stack([a.reshape(-1)[idx] for a in (ax, ay, az)], dim=-1)
            u = u.to(torch.float32) / 255.0 * 2.0 - 1.0
            nrm = torch.sqrt(u[:, 0] * u[:, 0] + u[:, 1] * u[:, 1] + u[:, 2] * u[:, 2])
            dirs = u / torch.where(nrm > 0, nrm, torch.ones_like(nrm))[:, None]
            z = idx // (h * w)
            rem = idx % (h * w)
            pos = torch.stack([rem % w, rem // w, z + s * zl], dim=-1).to(torch.float32)
            mine[s] = (pos.cpu().numpy(), dirs.cpu().numpy(), (vals > 0).cpu().numpy(),
                       np.int32(mask.sum().item()))
    per_shard = _gather_shards(mesh, mine)
    return (np.concatenate([p[0] for p in per_shard]), np.concatenate([p[1] for p in per_shard]),
            np.concatenate([p[2] for p in per_shard]),
            np.array([p[3] for p in per_shard], np.int32))


def build_local_trace_step(cfg, mesh: Mesh, seeds_per_shard: int,
                           trace_halo: Optional[int] = None):
    """Shard-local tracing: the volume never replicates.

    Each shard traces the `seeds_per_shard` seeds of its lanes (bucket
    them with `assign_seeds_to_shards`) against the likelihood field of
    its `trace_halo` slab (default: the template reach ceil(4.5 * max
    sigma) plus 4 transition steps), in one stage of ni - 1 iterations,
    and a trace ends where its centroid leaves the slab. Positions stay
    in the volume's coordinates (the tracer reads the slab through its
    `SlabFrame`), so a trace that stays inside its slab is bitwise the
    single-device trace. patch_reuse is forced to 1, as in JAX.

    Returns step(vs, seed_pos (n*k, 3), seed_dir, base_key) -> host (n*k,
    ni, 9) estimates; lane i is keyed fold_in(base_key, i)."""
    from pnr_tpu_torch.ops.threefry import key_tensor
    from pnr_tpu_torch.parallel.handoff import Trackers, build_fields
    from pnr_tpu_torch.smc.tracker import trace_keys

    n, k = mesh.size, int(seeds_per_shard)
    trackers = Trackers(cfg, mesh)
    if trace_halo is None:
        trace_halo = int(math.ceil(4.5 * max(cfg.sigmas))) + 4 * cfg.step

    def step(vs, seed_pos, seed_dir, base_key):
        fields = build_fields(trackers, mesh, vs, trace_halo, n * shard_len(vs))
        sp = np.asarray(seed_pos, np.float32)
        sd = np.asarray(seed_dir, np.float32)
        keys = trace_keys(base_key, np.arange(n * k))
        mine = {}
        for s, dev in enumerate(mesh.devices):
            if fields[s] is None:  # another process's shard
                continue
            f, frame = fields[s]
            sl = slice(s * k, (s + 1) * k)
            tracker = trackers[dev]
            with on(dev):
                kd = key_tensor(keys[sl], dev)
                carry, e0 = tracker.trace_init(f, sp[sl], sd[sl], kd, frame)
                _, packed = tracker.trace_stage(f, kd, carry, 1, cfg.ni - 1,
                                                torch.zeros(k, dtype=torch.bool, device=dev), frame)
                mine[s] = torch.cat([e0[:, None, :], packed], dim=1).cpu().numpy()
        return np.concatenate(_gather_shards(mesh, mine))

    return step


def build_sharded_step(cfg, mesh: Mesh, wave: int = 8):
    """One full pipeline step over the mesh: the sharded filter (K4 and K3
    on each slab) -> global J8 -> `seeds_sharded` -> one trace wave over
    the shards with boundary handoff (`build_handoff_trace_step`, four
    iterations a stage); the volume never replicates.

    Each shard seeds up to ceil(wave / n) traces (rounded up, so no seed
    lane is lost when the mesh does not divide the wave) in 2 * that + 2
    lanes (headroom for arrivals). Returns step(vs, base_key) -> dict with
    JAX's keys: "j8" (sharded, on the devices), "seed_pos", "seed_valid",
    "seeds_found", "est_packs" (S+1, n*lanes, 4, 9), "est_ids" (S+1,
    n*lanes), "trace_valid", "handoff_lost" (host arrays); lane i's trace
    id is i."""
    from pnr_tpu_torch.parallel.handoff import build_handoff_trace_step

    n = mesh.size
    per_shard = max(1, -(-wave // n))
    lanes = 2 * per_shard + 2
    handoff_step, _, _ = build_handoff_trace_step(cfg, mesh, lanes_per_shard=lanes, stage_iters=4)

    def step(vs, base_key):
        j, jmin, jmax, vx, vy, vz = frangi3d_sharded(
            vs, cfg.sigmas, cfg.zdist, mesh, cfg.frangi_alpha, cfg.frangi_beta, cfg.frangi_c)
        j8 = normalize_to_u8_sharded(j, jmin, jmax)
        j = None
        seed_pos, seed_dir, valid, found = seeds_sharded(j8, vx, vy, vz, cfg.tolerance, mesh,
                                                         per_shard)
        vx = vy = vz = None

        def pad_lanes(a, fill=0):
            a2 = a.reshape((n, per_shard) + a.shape[1:])
            widths = ((0, 0), (0, lanes - per_shard)) + ((0, 0),) * (a.ndim - 1)
            return np.pad(a2, widths, constant_values=fill).reshape((n * lanes,) + a.shape[1:])

        packs, est_ids, _live, lost = handoff_step(
            vs, pad_lanes(seed_pos), pad_lanes(seed_dir), np.arange(n * lanes),
            pad_lanes(valid, False), base_key)
        return {
            "j8": j8,
            "seed_pos": seed_pos,
            "seed_valid": valid,
            "seeds_found": found,
            "est_packs": packs,
            "est_ids": est_ids,
            "trace_valid": packs[..., 8] > 0.5,
            "handoff_lost": lost,
        }

    return step
