"""Distributed tracing with boundary handoff between shards.

Port of pnr_tpu/parallel/handoff.py for a one-process mesh
(parallel/sharded.py). Each shard owns `lanes_per_shard` lanes of a
`BatchedTracker` on its device, tracing against the likelihood field of
its trace-halo slab. Every stage each shard inspects its traces'
centroids, and a trace whose centroid has crossed into a neighbouring
slab ships its whole carry (particle positions, directions, weights,
resampling state, alive flag, key and trace id) to that neighbour, where
it continues in lockstep.

The move is JAX's capacity handshake (`handoff.py:170-200`), decided on
the host from the counts of each shard: a receiver grants up to its free
lanes, up-arrivals (from the shard below) first, then down-arrivals; a
sender releases only what was granted, ranked by lane; the receiver seats
the up-arrivals, then the down-arrivals, in its lowest free lanes. Movers
beyond the grant stay on their shard, tracing on its slab, and are
counted in `kept_local`; they retry at the next stage.

Where JAX moves the carry with `lax.ppermute` and keeps each shard's
positions relative to its slab, the port copies the carry's rows to the
neighbour's device (none on a virtual mesh) and keeps every position in
the volume's coordinates: the tracer reads its slab through a
`SlabFrame` (ops/slab.py), so a trace whose windows stay inside the slab
computes bitwise what it computes on the whole volume, and a handed-off
trace is bitwise the single-device trace, given the trace's keys (by
global trace id) and its draws (by absolute iteration, drawn on the
shard's device from its lanes' keys there).
The slabs are aligned windows (`halo_exchange_z_aligned`) rather than
JAX's edge-replicated ones, so the field is the whole volume's wherever a
slab meets a volume border too. A trace stops where its centroid leaves
the volume (the original extent, before the mesh padding) or its slab.
`patch_reuse` is forced to 1, as in JAX.

Each shard traces at JAX's shapes (`pnr_tpu/parallel/handoff.py:155-282`):
`init` traces all its lanes, the pad lanes too, and every stage traces
all its lanes with the free ones killed (`kill = ~live`, JAX's `:236`),
so a shard's stages have one shape. On a card they replay as CUDA graphs
(smc/graphs.py): each local shard's field has its runner, read through
the shard's `SlabFrame`, which captures at the first stage, as JAX
compiles its jitted stage at its first call. The carry and the keys then
live in the runner's static buffers, and the handshake reads the movers'
rows from them and seats arrivals into them in place, between replays
(`StageGraphs.writing`). The caller drops the runners when its tracing
ends (`drop_graphs`).

On a multi-process mesh (parallel/multihost.py) each process advances its
own shards' lanes; the handshake is decided from host data every process
holds alike (each shard's last estimates, gathered after every stage), so
every process takes the same decisions, and the carries of traces that
cross to another process's shard travel through one `multihost.exchange`;
the keys, trace ids and live flags of every shard are host arrays kept on
every process.

`build_handoff_tracer` returns (init, stage, n_stages):

    init(vs, seed_pos, seed_dir, trace_ids, valid, base_key, field=None)
        -> (state, est0 (L, 9), ids0 (L,), field)
    stage(field, state, iter_idx, kill (L,))
        -> (state, packed, ids (L,), live (L,), kept_local (n_shards,))

L = n_shards * lanes_per_shard, lanes [s*T, (s+1)*T) on shard s; seed_pos
are volume (x, y, z), bucketed by shard (the pipeline's `_bucket_by_shard`);
`valid` masks pad lanes. `field` is the per-shard (field, frame) list of
`build_fields`, built once and passed to every call. `iter_idx` are the
absolute iterations the stage runs, stage_iters of them on a card (the
runner's shape); `packed` holds each shard's (T, n, 9) estimates on their
way to the host (None for a shard with no live lane) and `lane_estimates`
gathers them (another process's shards as host arrays). `ids` is -1 on
free lanes; est0, ids, live and kept_local are host arrays.

`build_handoff_trace_step` is JAX's one-shot API on top of it (every
stage at stage_iters iterations, no kill feedback, the blocks stacked),
and `stitch_estimates` reassembles its blocks into per-trace records.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import List, Optional

import numpy as np
import torch

from pnr_tpu_torch.config import PNRConfig
from pnr_tpu_torch.ops.slab import SlabFrame
from pnr_tpu_torch.ops.threefry import key_tensor
from pnr_tpu_torch.parallel.halo import halo_exchange_z_aligned
from pnr_tpu_torch.parallel.multihost import exchange
from pnr_tpu_torch.parallel.sharded import Mesh, on, shard_len
from pnr_tpu_torch.smc.tracker import BatchedTracker, trace_keys


def required_trace_halo(cfg: PNRConfig, stage_iters: int) -> int:
    """Minimum halo for the single-device trace (JAX's bound): the tube
    maps' convolution reach, the samples' reach and the centroid's drift
    between two handoff opportunities."""
    smax = max(cfg.sigmas)
    conv_reach = int(math.ceil(3.0 * smax))
    sample_reach = int(math.ceil(1.0 * smax)) + 2
    drift = stage_iters * 2 * cfg.step
    return conv_reach + sample_reach + drift


class Trackers:
    """One `BatchedTracker` per distinct device of a mesh, with
    patch_reuse 1: reuse widens the windows beyond what
    `required_trace_halo` budgets for, and its groups align to stage
    launches (JAX forces it too)."""

    def __init__(self, cfg: PNRConfig, mesh: Mesh, is2d: bool = False, stage_iters: int = 8):
        cfg = dataclasses.replace(cfg, patch_reuse=1)
        self.by_device = {}
        for d in mesh.local_devices:
            if d not in self.by_device:
                with on(d):
                    self.by_device[d] = BatchedTracker(cfg, d, stage_iters=stage_iters, is2d=is2d)

    def __getitem__(self, device) -> BatchedTracker:
        return self.by_device[device]


def build_fields(trackers: Trackers, mesh: Mesh, vs, halo: int, extent: int, is2d: bool = False):
    """Per shard (field, frame): the likelihood field of the shard's aligned
    `halo` slab on its device, and where the slab lies in the volume of
    `extent` planes (rows, when `is2d`: `vs` is then the transposed
    (Y, 1, X) layout and each slab is turned back to (1, S, X)). Another
    process's shard gets None."""
    out = []
    zl = shard_len(vs)
    for i, (dev, got) in enumerate(zip(mesh.devices, halo_exchange_z_aligned(vs, halo, mesh))):
        if got is None:
            out.append(None)
            continue
        slab, off = got
        w0 = i * zl - off
        with on(dev):
            if is2d:
                slab = slab.permute(1, 0, 2).contiguous()
                frame = SlabFrame((0, w0, 0), (1, extent, int(slab.shape[2])))
            else:
                frame = SlabFrame((w0, 0, 0), (extent, int(slab.shape[1]), int(slab.shape[2])))
            out.append((trackers[dev].prepare_field(slab), frame))
        slab = None
    return out


def drop_graphs(trackers: Trackers, mesh: Mesh, fields) -> None:
    """Drop the stage-graph runners of the local shards' fields (their
    tracing has ended)."""
    for dev, got in zip(mesh.devices, fields):
        if got is not None:
            trackers[dev].drop_stage_graphs(got[0])


@dataclasses.dataclass
class HandoffState:
    """The lanes of every shard: the tracker carries on the devices (the
    runner's static buffers on a card; None for another process's shard);
    keys, trace ids and live flags on the host, and each local shard's
    keys on its device (`dkeys`, (T, 2) int32, the runner's buffer on a
    card; None for another process's shard); each local shard's runner
    (None where stages run eagerly); `last` per shard its last (T, n, 9)
    estimates (est0 as (T, 1, 9) after `init`), read through `_host`, None
    when the shard traced nothing."""

    zl: int  # planes (rows) per shard
    carry: list
    keys: List[np.ndarray]
    ids: List[np.ndarray]
    live: List[np.ndarray]
    last: list
    dkeys: list
    runners: list


class _Fetch:
    """A shard's stage estimates (a device tensor, or a runner's
    `PendingStage`), fetched to the host once."""

    __slots__ = ("src", "host")

    def __init__(self, src):
        self.src, self.host = src, None

    def numpy(self) -> np.ndarray:
        if self.host is None:
            src, self.src = self.src, None
            self.host = src.cpu().numpy() if torch.is_tensor(src) else src.numpy()
        return self.host


def _host(a):
    """A shard's estimates on the host (a host array or None as it is)."""
    if isinstance(a, _Fetch):
        return a.numpy()
    return a.cpu().numpy() if torch.is_tensor(a) else a


def lane_estimates(packed, lanes: int, n_it: int) -> np.ndarray:
    """A stage's per-shard estimates as one host (L, n_it, 9) array."""
    return np.concatenate([
        np.zeros((lanes, n_it, 9), np.float32) if p is None else _host(p) for p in packed
    ])


def _cross_process_rows(mesh: Mesh, up_lanes, dn_lanes, up_rows, dn_rows) -> None:
    """The carries of traces whose move crosses to another process's shard,
    sent through one `exchange` when any does (every process decides that
    from the same host lanes): each receiving process gets the rows of its
    remote senders, as host tensors, in `up_rows`/`dn_rows` in place."""
    n = mesh.size
    crossing = [("up", s) for s in range(n - 1)
                if len(up_lanes[s]) and mesh.ranks[s] != mesh.ranks[s + 1]]
    crossing += [("dn", s) for s in range(1, n)
                 if len(dn_lanes[s]) and mesh.ranks[s] != mesh.ranks[s - 1]]
    if not crossing:
        return
    rows = {"up": up_rows, "dn": dn_rows}
    mine = {(d, s): tuple(r.cpu().numpy() for r in rows[d][s])
            for d, s in crossing if mesh.is_local(s)}
    for part in exchange(mine):
        for (d, s), arrs in part.items():
            if not mesh.is_local(s):
                rows[d][s] = tuple(torch.from_numpy(a) for a in arrs)


def _share(mesh: Mesh, per_shard: list) -> None:
    """On a multi-process mesh, fill in the other processes' entries of
    `per_shard` (their estimates) in place, as host arrays, and turn this
    process's into host arrays too."""
    if not mesh.multiprocess:
        return
    mine = {s: _host(per_shard[s]) for s in range(mesh.size) if mesh.is_local(s)}
    for part in exchange(mine):
        for s, e in part.items():
            per_shard[s] = e


def build_handoff_tracer(
    cfg: PNRConfig,
    mesh: Mesh,
    lanes_per_shard: int,
    stage_iters: int = 4,
    trace_halo: Optional[int] = None,
    z_total: Optional[int] = None,
    is2d: bool = False,
    trackers: Optional[Trackers] = None,
):
    """Staged distributed tracer (see the module docstring). `z_total`
    bounds the trace along the sharded axis (default: the sharded volume's
    extent; the pipeline passes the original extent of a padded volume).
    With `is2d` a one-plane image shards over Y: `vs` holds the transposed
    (Y, 1, X) layout and traces migrate on their centroid's y. `trackers`:
    the caller's, when it builds the fields itself."""
    n = mesh.size
    t_lanes = int(lanes_per_shard)
    ci = 1 if is2d else 2  # migrating coordinate in (x, y, z) estimates
    if trace_halo is None:
        trace_halo = required_trace_halo(cfg, stage_iters)
    if trackers is None:
        trackers = Trackers(cfg, mesh, is2d, stage_iters)
    if any(t.STAGE_ITERS != stage_iters for t in trackers.by_device.values()):
        raise ValueError(f"build_handoff_tracer: the trackers' stages are not {stage_iters} "
                         "iterations long")
    n_stages = -(-(cfg.ni - 1) // stage_iters)

    def init(vs, seed_pos, seed_dir, trace_ids, valid, base_key, field=None):
        if field is None:
            extent = z_total if z_total is not None else n * shard_len(vs)
            field = build_fields(trackers, mesh, vs, trace_halo, extent, is2d)
        sp = np.asarray(seed_pos, np.float32)
        tids = np.asarray(trace_ids, np.int64)
        valid = np.asarray(valid, bool)
        sd = np.asarray(seed_dir, np.float32)
        state = HandoffState(shard_len(vs), [], [], [], [], [], [], [])
        est0 = []
        for s, dev in enumerate(mesh.devices):
            sl = slice(s * t_lanes, (s + 1) * t_lanes)
            keys = trace_keys(base_key, tids[sl])
            state.keys.append(keys)
            state.ids.append(tids[sl].copy())
            state.live.append(valid[sl].copy())
            if not mesh.is_local(s):  # another process's shard
                state.carry.append(None)
                state.dkeys.append(None)
                state.runners.append(None)
                est0.append(None)
                continue
            f, frame = field[s]
            tracker = trackers[dev]
            with on(dev):
                dkeys = key_tensor(keys, dev)
                # every lane, the pad lanes too (JAX's init); they stay free
                carry, e0 = tracker.trace_init(f, sp[sl], sd[sl], dkeys, frame)
                e0[:, 8] *= torch.from_numpy(valid[sl]).to(dev)
                runner = tracker.stage_graphs(f, frame)  # None: eager stages
                if runner is not None:
                    runner.load(0, carry, dkeys)
                    carry, dkeys = runner.buffers(0, t_lanes)
            state.carry.append(carry)
            state.dkeys.append(dkeys)
            state.runners.append(runner)
            est0.append(e0)
        _share(mesh, est0)
        est0 = [None if e is None else _host(e) for e in est0]
        state.last = [None if e is None else e[:, None] for e in est0]
        return state, np.concatenate(est0), _ids(state), field

    def _ids(state):
        return np.concatenate([np.where(lv, i, -1) for i, lv in zip(state.ids, state.live)])

    def stage(field, state: HandoffState, iter_idx, kill):
        it0, n_it = int(iter_idx[0]), len(iter_idx)
        kill = np.asarray(kill, bool)
        zl = state.zl
        live = [state.live[s] & ~kill[s * t_lanes:(s + 1) * t_lanes] for s in range(n)]
        moving, go_up, go_dn = [], [], []
        for s in range(n):
            if state.last[s] is None:
                m = np.zeros(t_lanes, bool)
                owner = np.full(t_lanes, s)
            else:
                last = _host(state.last[s])[:, -1]  # JAX's last_cz, and alive
                owner = np.clip(np.floor(last[:, ci] / zl).astype(np.int64), 0, n - 1)
                m = live[s] & (last[:, 8] > 0.5) & (owner != s)
            moving.append(m)
            go_up.append(m & (owner > s))
            go_dn.append(m & (owner < s))

        # ---- the capacity handshake: counts down and up, grants back ----
        free_n = [int((~lv).sum()) for lv in live]
        up_in = [int(go_up[s - 1].sum()) if s > 0 else 0 for s in range(n)]
        dn_in = [int(go_dn[s + 1].sum()) if s < n - 1 else 0 for s in range(n)]
        accept_up = [min(up_in[s], free_n[s]) for s in range(n)]
        accept_dn = [min(dn_in[s], free_n[s] - accept_up[s]) for s in range(n)]
        kept = np.zeros(n, np.int64)
        for s in range(n):
            up_grant = accept_up[s + 1] if s < n - 1 else 0
            dn_grant = accept_dn[s - 1] if s > 0 else 0
            go_up[s] &= (np.cumsum(go_up[s]) - 1) < up_grant
            go_dn[s] &= (np.cumsum(go_dn[s]) - 1) < dn_grant
            kept[s] = int(moving[s].sum()) - int(go_up[s].sum()) - int(go_dn[s].sum())
        up_lanes = [np.nonzero(m)[0] for m in go_up]
        dn_lanes = [np.nonzero(m)[0] for m in go_dn]

        # the carries and keys are read and written on the caller's streams,
        # after the runners' last stages and before their next
        with contextlib.ExitStack() as between:
            for r in state.runners:
                if r is not None:
                    between.enter_context(r.writing())
            _move(state, live, up_lanes, dn_lanes)

        # ---- advance every lane of every shard, the free ones killed ----
        packed = []
        for s, dev in enumerate(mesh.devices):
            if not mesh.is_local(s):
                packed.append(None)  # `_share` brings its estimates
                continue
            if not live[s].any():
                packed.append(None)
                continue
            f, frame = field[s]
            runner = state.runners[s]
            with on(dev):
                if runner is not None:
                    if n_it != runner.tracker.STAGE_ITERS:
                        raise ValueError(f"a replayed handoff stage runs "
                                         f"{runner.tracker.STAGE_ITERS} iterations, not {n_it}")
                    pk = runner.stage(0, it0, ~live[s])
                else:
                    state.carry[s], pk = trackers[dev].trace_stage(
                        f, state.dkeys[s], state.carry[s], it0, n_it,
                        torch.from_numpy(~live[s]).to(dev), frame)
            packed.append(_Fetch(pk))
        _share(mesh, packed)
        state.last = list(packed)
        state.live = live
        return state, packed, _ids(state), np.concatenate(live), kept

    def _move(state, live, up_lanes, dn_lanes):
        """Hand the granted movers to their neighbours: read their rows,
        free their lanes and seat them in each receiver's lowest free lanes
        (up-arrivals first), carries and keys written in place."""

        def rows_of(s, lanes):
            if not len(lanes) or not mesh.is_local(s):
                return None
            idx = torch.from_numpy(lanes).to(mesh.devices[s])
            return tuple(a.index_select(0, idx) for a in state.carry[s])

        up_rows = [rows_of(s, up_lanes[s]) for s in range(n)]
        dn_rows = [rows_of(s, dn_lanes[s]) for s in range(n)]
        if mesh.multiprocess:
            _cross_process_rows(mesh, up_lanes, dn_lanes, up_rows, dn_rows)
        # per receiver: (device rows, keys, trace ids) of the up-arrivals
        # (from s-1), then of the down-arrivals (from s+1)
        arrivals = [[] for _ in range(n)]
        for s in range(n):
            if s < n - 1 and len(up_lanes[s]):
                arrivals[s + 1].append(
                    (up_rows[s], state.keys[s][up_lanes[s]], state.ids[s][up_lanes[s]]))
        for s in range(n):
            if s > 0 and len(dn_lanes[s]):
                arrivals[s - 1].append(
                    (dn_rows[s], state.keys[s][dn_lanes[s]], state.ids[s][dn_lanes[s]]))
        for s in range(n):
            live[s][up_lanes[s]] = False
            live[s][dn_lanes[s]] = False
        for s, dev in enumerate(mesh.devices):
            local = mesh.is_local(s)
            for rows, k_in, i_in in arrivals[s]:
                dest = np.nonzero(~live[s])[0][:len(i_in)]
                if len(dest) < len(i_in):
                    raise AssertionError("handoff: the capacity handshake seated more traces "
                                         "than the receiver has free lanes")
                if local:
                    with on(dev):
                        didx = torch.from_numpy(dest).to(dev)
                        for a, r in zip(state.carry[s], rows):
                            a.index_copy_(0, didx, r.to(dev))
                        state.dkeys[s].index_copy_(0, didx, key_tensor(k_in, dev))
                state.keys[s][dest] = k_in
                state.ids[s][dest] = i_in
                live[s][dest] = True

    return init, stage, n_stages


def build_handoff_trace_step(
    cfg: PNRConfig,
    mesh: Mesh,
    lanes_per_shard: int,
    stage_iters: int = 4,
    trace_halo: Optional[int] = None,
):
    """One-shot API over `build_handoff_tracer`: run every stage with no
    kill feedback and return the stacked per-stage blocks.

    Returns (step, n_stages, stage_iters); step(vs, seed_pos, seed_dir,
    trace_ids, valid, base_key) -> (packed (S+1, L, stage_iters, 9), ids
    (S+1, L), live (S+1, L), lost (n_shards,)), host arrays. Block 0 holds
    iteration 0 in its first row; every stage runs stage_iters iterations,
    and those of the last stage past ni are invalid (valid column 0, as in
    JAX). `lost` is always zero (the capacity handshake keeps
    overflow traces on their shard instead of dropping them) and is kept
    for JAX's API."""
    trackers = Trackers(cfg, mesh, stage_iters=stage_iters)
    init, stage, n_stages = build_handoff_tracer(cfg, mesh, lanes_per_shard, stage_iters,
                                                 trace_halo, trackers=trackers)

    def step(vs, seed_pos, seed_dir, trace_ids, valid, base_key):
        state, est0, ids0, field = init(vs, seed_pos, seed_dir, trace_ids, valid, base_key)
        lanes = len(ids0)
        packs = [np.pad(est0[:, None, :], ((0, 0), (0, stage_iters - 1), (0, 0)))]
        ids_all, live_all = [ids0], [np.concatenate(state.live)]
        no_kill = np.zeros(lanes, bool)
        it = 1
        try:
            for _ in range(n_stages):
                state, packed, ids, live, _kept = stage(field, state,
                                                        range(it, it + stage_iters), no_kill)
                blk = lane_estimates(packed, lanes_per_shard, stage_iters)
                n_it = min(stage_iters, cfg.ni - it)
                blk[:, n_it:, 8] = 0.0  # the rows past ni (JAX's)
                packs.append(blk)
                ids_all.append(ids)
                live_all.append(live)
                it += n_it
        finally:
            drop_graphs(trackers, mesh, field)
        return (np.stack(packs), np.stack(ids_all), np.stack(live_all),
                np.zeros(mesh.size, np.int32))

    return step, n_stages, stage_iters


def stitch_estimates(packs: np.ndarray, ids: np.ndarray, ni: int):
    """Reassemble per-trace estimate records from per-stage blocks.

    packs (S+1, L, stage_iters, 9), ids (S+1, L) with -1 for empty lanes.
    Returns (est (n_traces, ni, 9), trace_ids (n_traces,)) in ascending
    trace-id order; iteration 0 comes from stage block 0. Validity is a
    prefix property (the tracker's alive chain): one invalid iteration
    invalidates everything after it."""
    s_tot, lanes, stage_iters, _ = packs.shape
    all_ids = np.unique(ids[ids >= 0])
    est = np.zeros((len(all_ids), ni, 9), np.float32)
    id_to_row = {int(t): r for r, t in enumerate(all_ids)}
    for s in range(s_tot):
        it0 = 0 if s == 0 else 1 + (s - 1) * stage_iters
        n_it = 1 if s == 0 else min(stage_iters, ni - it0)
        if n_it <= 0:
            continue
        for lane in np.nonzero(ids[s] >= 0)[0]:
            est[id_to_row[int(ids[s, lane])], it0:it0 + n_it] = packs[s, lane, :n_it]
    est[:, :, 8] = np.minimum.accumulate(est[:, :, 8], axis=1)
    return est, all_ids
