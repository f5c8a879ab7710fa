"""Multi-device reconstruction: the full pipeline over a mesh of devices.

Port of pnr_tpu/pipeline/sharded_reconstruct.py. Same contract as
`reconstruction_func`, with the heavy stages sharded over a 1-D mesh
(parallel/sharded.py: shard i on the mesh's device i; a virtual mesh puts
every shard on one card; a mesh from `multihost.make_global_mesh` spans
several processes) — Z slabs for 3-D volumes, Y slabs (through the
transposed (Y, 1, X) layout) for a one-plane image:

* soma extraction: per-slab erosion and xy Gaussian (K3 on a card; no
  halo in 3-D, a replicated Y halo in 2-D), one 256-bin histogram summed
  over the shards (the replicate padding masked out), the max-entropy
  threshold, and the 3-D connected components on the host on the gathered
  stack — bitwise the single-device stage;
* Frangi + J8: the unfused filter on each shard's aligned halo slab,
  global Jmin/Jmax (`frangi3d_sharded`, bitwise the monolithic filter);
* seed extraction: the native host flood on the gathered J8 (the
  single-process branch of JAX's pipeline; without the native library,
  `max_points_device` on each shard's planes on its device, as JAX
  floods on its device), directions decoded on each shard's maps; over
  several processes each floods only its own slabs
  (`_seeds_per_shard_multiprocess`), and the seed rows are all-gathered;
* seed scoring: each seed on its shard's field (`score_seeds_sharded`);
* tracing: shard-local SMC with boundary handoff (parallel/handoff.py),
  run in stages with the single-device path's in-order commit wavefront
  and kill-back, and JAX's pipelined loop where lane capacity cannot
  bind.

Each shard builds its likelihood field once, on its aligned trace-halo
slab (`required_trace_halo`), and seed scoring and every wave use it
(JAX rebuilds it each wave). Positions stay in the volume's coordinates
(ops/slab.py), so a trace that stays inside its slab is bitwise the
single-device trace.

Arbitrary extents are replicate-padded to a mesh multiple: the clamped
stencils read the edge slice either way, so results in the original
region are unchanged; seeds in the padding are discarded and the
tracer's stop bound stays the original extent. Lane overflow never loses
traces: seeds that do not fit a wave's lanes are re-queued into the next
wave, and in-flight migration overflow keeps traces on their shard.
Checkpoint and resume snapshot the commit state between waves in the
single-device path's format, so either path resumes the other's run.

Over several processes (parallel/multihost.py) every process runs this
driver alike on the same input: the redundant host driver. The device
stages run on each process's own shards, and what the host reads crosses
processes through `multihost.exchange` (the halos, Jmin/Jmax, the seed
rows and scores, the handoff's lanes, the maps the result returns); the
bytes each stage received are in the result's `received_bytes`. Only rank
0 writes a checkpoint; every process reads it on resume.
"""

from __future__ import annotations

import math
import os
import sys
from typing import List, Optional

import numpy as np
import torch

from pnr_tpu_torch.config import PNRConfig
from pnr_tpu_torch.graph.build import TraceCommitter
from pnr_tpu_torch.graph.nodes import SOMA, NodeList
from pnr_tpu_torch.hostpath import threefry as tf
from pnr_tpu_torch.io.volume import as_u8_volume
from pnr_tpu_torch import native
from pnr_tpu_torch.ops.gaussian import imgaussian_xy
from pnr_tpu_torch.ops.morphology import imerode_xy
from pnr_tpu_torch.ops.thresholds import histogram256, maxentropy_th
from pnr_tpu_torch.parallel.halo import halo_exchange_z
from pnr_tpu_torch.parallel.handoff import (
    Trackers,
    build_fields,
    build_handoff_tracer,
    drop_graphs,
    lane_estimates,
    required_trace_halo,
)
from pnr_tpu_torch.parallel import multihost
from pnr_tpu_torch.parallel.multihost import exchange, fetch_replicated
from pnr_tpu_torch.parallel.sharded import (
    Mesh,
    frangi2d_sharded,
    frangi3d_sharded,
    normalize_to_u8_sharded,
    on,
    shard_len,
    shard_volume,
)
from pnr_tpu_torch.pipeline.checkpoint import load_checkpoint, save_checkpoint
from pnr_tpu_torch.pipeline.reconstruct import (
    ReconstructionResult,
    reconstruct_graph,
    smap_to_u8,
)
from pnr_tpu_torch.seeds.extract import (
    decode_directions_device,
    max_points_device,
    max_points_host,
    seed_mask,
)
from pnr_tpu_torch.utils.exporters import low_signal_diagnostic
from pnr_tpu_torch.utils.runtime import require_cuda
from pnr_tpu_torch.utils.spans import StageTimer


def _pad_axis_replicate(vol: np.ndarray, n_dev: int, axis: int = 0) -> np.ndarray:
    """Pad an axis to a mesh multiple by replicating the last slice —
    exact for clamped-border stencils (the beyond-edge taps read the
    edge slice either way)."""
    n = vol.shape[axis]
    npad = -(-n // n_dev) * n_dev - n
    if npad == 0:
        return vol
    pad = np.repeat(np.take(vol, [-1], axis=axis), npad, axis=axis)
    return np.concatenate([vol, pad], axis=axis)


def _pad_z_replicate(vol: np.ndarray, n_dev: int) -> np.ndarray:
    return _pad_axis_replicate(vol, n_dev, axis=0)


def _owner(pos: np.ndarray, zl: int, n: int, ci: int) -> np.ndarray:
    """The shard whose slab holds each position's coordinate `ci`."""
    return np.clip((pos[:, ci] // zl).astype(np.int64), 0, n - 1)


def _decode_seed_dirs(vx, vy, vz, pos: np.ndarray, ci: int = 2) -> np.ndarray:
    """The seed directions at `pos` (N, 3) xyz, decoded on the shards' maps
    (each seed on the shard that holds it, at its shard-local voxel); over
    several processes each decodes its own shards' seeds and the rows are
    all-gathered."""
    dirs = np.zeros((len(pos), 3), np.float32)
    if not len(pos):
        return dirs
    zl = shard_len(vx)
    owner = _owner(pos, zl, len(vx), ci)
    mine = {}
    for s in range(len(vx)):
        sel = np.nonzero(owner == s)[0]
        if len(sel) and vx[s] is not None:
            local = pos[sel].copy()
            local[:, ci] -= s * zl
            with on(vx[s].device):
                mine[s] = (sel, decode_directions_device(vx[s], vy[s], vz[s], local))
    if any(t is None for t in vx):
        for part in exchange(mine):
            mine.update(part)
    for sel, d in mine.values():
        dirs[sel] = d
    return dirs


def _flood_gathered(j8, j8_np: np.ndarray, tolerance, span_orig: int, is2d: bool,
                    mesh: Mesh) -> np.ndarray:
    """The seed flood of one process's run, routed as JAX's `_host_flood`:
    the native flood on the gathered J8 when the library is built, else
    `max_points_device`. Slices flood alone, so each Z shard floods its
    own planes on its own device; a plane (the transposed 2-D layout
    shards rows) floods on the first shard's device."""
    if native.have_native():
        return max_points_host(j8_np, float(tolerance))
    if is2d:
        return max_points_device(torch.from_numpy(j8_np).to(mesh.devices[0]),
                                 float(tolerance)).cpu().numpy()
    zl = shard_len(j8)
    parts = [max_points_device(t[:min(zl, span_orig - s * zl)], float(tolerance)).cpu().numpy()
             for s, t in enumerate(j8) if span_orig > s * zl]
    return np.concatenate(parts)


def _seeds_per_shard_multiprocess(j8, vx, vy, vz, tolerance, span_orig: int):
    """Slab-local seed extraction over several processes (JAX's
    `_seeds_per_shard_multiprocess`): the reference's tolerance flood runs
    on each z-slice alone (seed.cpp:574-791), and a Z shard holds whole
    slices, so each process floods only its own shards' J8 (`seed_mask`:
    the native MaximumFinder, or the device flood on the shard's device
    without it) and decodes their directions on its own maps; no process
    gathers a volume-sized array. The (x, y, z, direction) rows are
    all-gathered (`allgather_host_rows`) and sorted by (z, y, x), the order
    of `np.nonzero` on the whole volume, so every process holds the same
    seed list, the single-device one."""
    zl = shard_len(j8)
    rows = []
    for s, t in enumerate(j8):
        if t is None:
            continue
        z0 = s * zl
        zmax = min(zl, span_orig - z0)
        if zmax <= 0:
            continue  # the shard lies in the replicate padding
        zz, yy, xx = np.nonzero(seed_mask(t[:zmax], tolerance))
        if not len(zz):
            continue
        local = np.stack([xx, yy, zz], axis=-1).astype(np.float32)
        with on(t.device):
            d = decode_directions_device(vx[s], vy[s], vz[s], local)
        local[:, 2] += z0
        rows.append(np.concatenate([local, d], axis=1))
    rows = np.concatenate(rows) if rows else np.zeros((0, 6), np.float32)
    rows = multihost.allgather_host_rows(rows)
    rows = rows[np.lexsort((rows[:, 0], rows[:, 1], rows[:, 2]))]
    return rows[:, :3].copy(), rows[:, 3:].copy()


def soma_extraction_sharded(vs, vol_shape, cfg: PNRConfig, nodes: NodeList, mesh: Mesh,
                            verbose=False, is2d: bool = False) -> np.ndarray:
    """Sharded soma extraction (Advantra_plugin.cpp:2426-2481): the xy
    erosion and xy Gaussian on each shard, a global max-entropy threshold
    from the shards' summed histograms, the 3-D connected components on
    the host on the gathered stack. Returns the int32 smap with
    `vol_shape` (original extents), bitwise the single-device stage's.

    3-D: Z slabs, no halo (both stencils are xy-only, frangi.cpp:879,
    786). 2-D (`is2d`): `vs` holds the transposed (Y, 1, X) layout sharded
    over Y; the stencils reach ceil(r) + ceil(3r) rows, exchanged as an
    edge-replicated Y halo. Replicate-padded rows or slices are left out
    of the histogram, so the threshold is the single-device one."""
    r = float(cfg.somaradius)
    span_orig = vol_shape[1] if is2d else vol_shape[0]
    halo = (int(math.ceil(r)) + int(math.ceil(3.0 * r))) if is2d else 0
    padded = halo_exchange_z(vs, halo, mesh) if is2d else vs
    hist = torch.zeros(256, dtype=torch.int64)
    e8s = []
    for s, (dev, v, p) in enumerate(zip(mesh.devices, vs, padded)):
        if v is None:  # another process's shard
            e8s.append(None)
            continue
        sl = int(v.shape[0])
        with on(dev):
            if is2d:
                img = p.permute(1, 0, 2).contiguous()  # (1, Yl + 2h, X)
                e8 = imgaussian_xy(imerode_xy(img, r), r)
                e8 = e8[:, halo:halo + sl].permute(1, 0, 2).contiguous()  # (Yl, 1, X)
            else:
                e8 = imgaussian_xy(imerode_xy(v, r), r)
            keep = max(0, min(sl, span_orig - s * sl))  # the shard's unpadded slices
            if keep:
                hist += histogram256(e8[:keep]).cpu().to(torch.int64)
        e8s.append(e8)
    if mesh.multiprocess:
        hist = torch.from_numpy(np.sum(exchange(hist.numpy()), axis=0))
    th = maxentropy_th(hist.to(torch.int32))
    e8_np = fetch_replicated(e8s)
    e8_np = e8_np.transpose(1, 0, 2)[:, :span_orig] if is2d else e8_np[:span_orig]
    e8bin = np.where(e8_np > th, 255, 0).astype(np.uint8)
    labels, regions = native.conn3d(e8bin, value_over=0, min_size=1, diagonal=True)
    base = len(nodes) - 1
    for rg in range(len(regions)):
        nodes.add(regions[rg, 0], regions[rg, 1], regions[rg, 2], sig=regions[rg, 3], ntype=SOMA)
    return np.where(labels > 0, labels + base, 0).astype(np.int32)


def score_seeds_sharded(trackers: Trackers, mesh: Mesh, fields, pos: np.ndarray,
                        dirs: np.ndarray, zl: int, ci: int = 2) -> np.ndarray:
    """Shard-local znccBBB seed scoring: each seed on the field of the
    shard that holds it (its window placed as in the whole volume, so the
    score is the single-device one), B=1, in chunks of 1024 (tube) or
    4096 (exact) as `_score_seeds`. Over several processes each scores
    its own shards' seeds and the scores are all-gathered."""
    corr = np.full(len(pos), -np.inf, np.float32)
    owner = _owner(pos, zl, mesh.size, ci)
    for s, dev in enumerate(mesh.devices):
        sel = np.nonzero(owner == s)[0]
        if not mesh.is_local(s):
            continue
        field, frame = fields[s]
        tracker = trackers[dev]
        chunk = 1024 if tracker.tube else 4096
        for beg in range(0, len(sel), chunk):
            idx = sel[beg:beg + chunk]
            with on(dev):
                p = torch.from_numpy(np.ascontiguousarray(pos[idx])).to(dev)
                d = torch.from_numpy(np.ascontiguousarray(dirs[idx])).to(dev)
                c, _ = tracker.engine.eval_fused(field, p[:, None, :], d[:, None, :], frame)
                corr[idx] = c[:, 0].cpu().numpy()
    if mesh.multiprocess:
        mine = np.nonzero([mesh.is_local(s) for s in range(mesh.size)])[0]
        sel = np.nonzero(np.isin(owner, mine))[0]
        for idx, c in exchange((sel, corr[sel])):
            corr[idx] = c
    return corr


def build_seed_scorer(cfg: PNRConfig, mesh: Mesh, is2d: bool = False):
    """Shard-local znccBBB seed scoring as a library step (JAX's
    `build_seed_scorer`): score(vs, seed_pos, seed_dir) -> host (N,) corr.
    Each shard builds the likelihood field of its slab and scores the
    seeds in its slab on it (`score_seeds_sharded`), so every score is the
    single-device one. The halo is one tracer iteration's
    (`required_trace_halo(cfg, 1)`): JAX's scorer halo, the map and
    template reach, plus the reach of the engines' windows. patch_reuse is
    forced to 1, as in JAX. With `is2d`, `vs` is the transposed (Y, 1, X)
    layout sharded over Y and seeds go to the shard of their y."""
    trackers = Trackers(cfg, mesh, is2d)
    ci = 1 if is2d else 2
    halo = required_trace_halo(cfg, 1)

    def score(vs, seed_pos, seed_dir):
        zl = shard_len(vs)
        fields = build_fields(trackers, mesh, vs, halo, mesh.size * zl, is2d)
        return score_seeds_sharded(trackers, mesh, fields, np.asarray(seed_pos, np.float32),
                                   np.asarray(seed_dir, np.float32), zl, ci)

    return score


def _bucket_by_shard(pos, dirs, ids, z_padded, n_shards, lanes, ci=2):
    """Fixed-lane per-shard buckets preserving the given order inside
    each shard (`ci` selects the sharded coordinate: z for 3-D, y for
    2-D). Returns (pos, dirs, ids, valid, dropped_ids) — overflow
    entries are RETURNED (for re-queueing), never silently lost."""
    zl = z_padded // n_shards
    out_p = np.zeros((n_shards * lanes, 3), np.float32)
    out_d = np.zeros((n_shards * lanes, 3), np.float32)
    out_d[:, 0] = 1.0
    out_i = np.zeros(n_shards * lanes, np.int64)
    valid = np.zeros(n_shards * lanes, bool)
    dropped: List[int] = []
    for s in range(n_shards):
        lo = s * zl
        hi = (s + 1) * zl if s < n_shards - 1 else z_padded + 1
        m = (pos[:, ci] >= lo) & (pos[:, ci] < hi)
        sel = np.nonzero(m)[0]
        dropped.extend(ids[sel[lanes:]].tolist())
        sel = sel[:lanes]
        k = len(sel)
        sl = slice(s * lanes, s * lanes + k)
        out_p[sl] = pos[sel]
        out_d[sl] = dirs[sel]
        out_i[sl] = ids[sel]
        valid[sl.start: sl.start + k] = True
    return out_p, out_d, out_i, valid, dropped


def reconstruction_func_sharded(
    vol: np.ndarray,
    cfg: PNRConfig,
    mesh: Mesh,
    verbose: bool = True,
    key: Optional[np.ndarray] = None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every_waves: int = 1,
    resume: bool = False,
    _lanes_override: Optional[int] = None,  # tests: force lane overflow
    stage_iters: int = 8,  # SMC iterations per stage between handoffs (JAX's)
) -> ReconstructionResult:
    """Full reconstruction of a (Z, Y, X) uint8 volume over `mesh`
    (`make_mesh(n)`: the cards cuda:0 ... n-1; a CPU mesh only when asked
    for, as the tests do; without a card a CUDA mesh raises).

    3-D volumes shard over Z; a one-plane image (the reference's
    first-class 2-D path, Advantra_plugin.cpp:2339) shards over Y through
    its transposed (Y, 1, X) layout, with `frangi2d` per shard and
    y-migration in the tracer; its seed flood runs on the gathered plane
    (the tolerance flood spans a whole slice, seed.cpp:574). `key` is the
    (2,) uint32 base key (default: the key of `cfg.seed`), as in
    `reconstruction_func`. Over several processes (`make_global_mesh`)
    every process calls it alike, with the same volume and config."""
    for d in mesh.local_devices:
        require_cuda(d)
    vol = as_u8_volume(vol)
    n_dev = mesh.size
    dev0 = mesh.local_devices[0]
    if verbose and dev0.type == "cuda":
        # pre-flight memory check per card (an estimate: warn, don't
        # refuse); a virtual mesh holds several shards on a card
        from pnr_tpu_torch.parallel.plan import card_memory_bytes, plan_sharded

        plan = plan_sharded(vol.shape, cfg, n_dev, card_memory_bytes(dev0),
                            stage_iters=stage_iters)
        per_card = max(mesh.devices.count(d) for d in mesh.devices)
        if plan.peak_bytes * per_card > plan.mem_bytes * plan.usable_fraction:
            print(f"warning: this run may exceed a card's memory ({per_card} shard(s) a card) — "
                  + plan.summary().replace("\n", "\n  "))
    is2d = vol.shape[0] == 1
    ci = 1 if is2d else 2  # the sharded coordinate in (x, y, z)
    span_orig = vol.shape[1] if is2d else vol.shape[0]
    if is2d:
        rep = np.ascontiguousarray(_pad_axis_replicate(vol, n_dev, axis=1).transpose(1, 0, 2))
    else:
        rep = _pad_z_replicate(vol, n_dev)
    if key is None:
        key = tf.key_from_seed(cfg.seed)
    zl = rep.shape[0] // n_dev

    tm = _MeteredTimer(verbose, list(mesh.local_devices))
    nodes = NodeList()
    smap = None
    vs = shard_volume(rep, mesh)

    if cfg.somaradius > 0:
        tm.start("soma extraction (sharded)")
        smap = soma_extraction_sharded(vs, vol.shape, cfg, nodes, mesh, verbose, is2d=is2d)
        tm.stop()

    tm.start("frangi (sharded)")
    if is2d:
        j, jmin, jmax, vx, vy, vz = frangi2d_sharded(
            vs, cfg.sigmas, mesh, cfg.frangi_betaone, cfg.frangi_betatwo)
    else:
        j, jmin, jmax, vx, vy, vz = frangi3d_sharded(
            vs, cfg.sigmas, cfg.zdist, mesh, cfg.frangi_alpha, cfg.frangi_beta, cfg.frangi_c)
    j8 = normalize_to_u8_sharded(j, jmin, jmax)
    j = jmin = jmax = None
    tm.stop()

    def _fetch_map(a):
        # de-transpose the internal (Y, 1, X) 2-D layout and drop the
        # replicate padding
        m = fetch_replicated(a)
        return m.transpose(1, 0, 2)[:, :span_orig] if is2d else m[:span_orig]

    tm.start("seed extraction (sharded)")
    if mesh.multiprocess and not is2d:
        # each process floods its own slabs: no volume-sized gather here
        pos, dirs = _seeds_per_shard_multiprocess(j8, vx, vy, vz, cfg.tolerance, span_orig)
        j8_np = None
    else:
        # one process, or a plane (the flood spans whole rows of the
        # transposed layout): the flood on the gathered J8
        j8_np = _fetch_map(j8)
        zz, yy, xx = np.nonzero(_flood_gathered(j8, j8_np, cfg.tolerance, span_orig, is2d, mesh))
        j8 = None
        pos = np.stack([xx, yy, zz], axis=-1).astype(np.float32)
        if is2d:
            # the decode reads the TRANSPOSED maps, where a seed's (x, y) is
            # at (x, 0, y)
            dirs = _decode_seed_dirs(vx, vy, vz, np.stack([xx, zz, yy], -1).astype(np.float32))
        else:
            dirs = _decode_seed_dirs(vx, vy, vz, pos)
    n_raw_seeds = len(pos)
    if not cfg.save_midres:
        vx = vy = vz = None
    # drop seeds inside the soma
    if smap is not None and len(pos):
        xi, yi, zi = (np.floor(pos[:, i] + 0.5).astype(int) for i in range(3))
        outside = smap[zi, yi, xi] == 0
        pos, dirs = pos[outside], dirs[outside]
    tm.stop()
    if verbose:
        print(f"{len(pos) / 1000.0}k seeds")

    tm.start("seed selection & sorting (sharded)")
    stage_iters = max(1, int(stage_iters))
    trackers = Trackers(cfg, mesh, is2d, stage_iters)
    fields = build_fields(trackers, mesh, vs, required_trace_halo(cfg, stage_iters), span_orig,
                          is2d)
    corr = np.zeros(0, np.float32)
    if len(pos):
        corr_all = score_seeds_sharded(trackers, mesh, fields, pos, dirs, zl, ci)
        keep = corr_all >= cfg.znccth
        pos, dirs, corr = pos[keep], dirs[keep], corr_all[keep]
        order = np.argsort(-corr, kind="stable")
        pos, dirs, corr = pos[order], dirs[order], corr[order]
    tm.stop()
    if verbose:
        print(f"{len(pos) / 1000.0}k seeds after selection")

    tm.start("tracing (sharded, staged handoff)")
    committer = TraceCommitter(vol.shape, cfg.vol, cfg.nodepervol, nodes, smap)
    wave = max(1, cfg.wave_size)
    # worst case: every trace of the wave in one slab always fits, so
    # re-queueing only triggers under a test override
    lanes = _lanes_override or 2 * wave
    init, stage, _ = build_handoff_tracer(cfg, mesh, lanes, stage_iters, z_total=span_orig,
                                          is2d=is2d, trackers=trackers)
    trace_count = 0
    idx = 0
    nseeds = len(pos)
    waves_done = 0
    totals = {"requeued": 0, "handoffs": 0, "kept_local": 0, "lost": 0}
    # lane-overflow re-queues + the unstarted tail of a cap-cut wave;
    # persisted in the checkpoint so a resume never skips them
    pending: List[int] = []
    if resume and checkpoint_path:
        if not os.path.exists(checkpoint_path):
            # loud on every process: one that started afresh would break the
            # redundant host driver (the same host state everywhere)
            raise FileNotFoundError(
                f"resume=True but no checkpoint at {checkpoint_path!r} (process "
                f"{mesh.rank}; over several hosts the snapshot must be on a shared filesystem)")
        committer, idx, trace_count, pending, ck_nseeds = load_checkpoint(checkpoint_path)
        if tuple(committer.shape) != tuple(vol.shape):
            raise ValueError(
                f"checkpoint was taken on a {tuple(committer.shape)} volume, "
                f"not {tuple(vol.shape)} — wrong checkpoint or wrong input"
            )
        if ck_nseeds >= 0 and ck_nseeds != nseeds:
            raise ValueError(
                f"checkpoint expects {ck_nseeds} seeds, this run selected "
                f"{nseeds} — the front-half config differs from the "
                "checkpointed run"
            )
        nodes = committer.nodes
        if verbose:
            print(f"resumed at seed {idx}, {trace_count} traces, |n0|={len(nodes)}")

    try:
        while (pending or idx < nseeds) and trace_count <= cfg.max_trace_count:
            batch: List[int] = []
            while pending and len(batch) < wave:
                si = pending.pop(0)
                if committer.seed_allowed(pos[si]):
                    batch.append(si)
            while idx < nseeds and len(batch) < wave:
                if committer.seed_allowed(pos[idx]):
                    batch.append(idx)
                idx += 1
            if not batch:
                break
            sel = np.asarray(batch)
            sp = np.repeat(pos[sel], 2, axis=0)
            sd = np.empty_like(sp)
            sd[0::2] = dirs[sel]
            sd[1::2] = -dirs[sel]
            tids = np.empty(2 * len(sel), np.int64)
            tids[0::2] = 2 * sel
            tids[1::2] = 2 * sel + 1
            bp, bd, bi, bv, dropped = _bucket_by_shard(sp, sd, tids, rep.shape[0], n_dev, lanes, ci)
            if dropped:
                # re-queue whole seeds whose traces did not fit this wave's
                # lanes (commit-order divergence, never loss)
                requeue = sorted({int(t) // 2 for t in dropped})
                bv = bv & ~np.isin(bi // 2, np.asarray(requeue))
                sel = sel[~np.isin(sel, np.asarray(requeue))]
                pending.extend(requeue)
                totals["requeued"] += len(requeue)
                if verbose:
                    print(f"wave lane overflow: re-queued {len(requeue)} seeds")
            if not len(sel):
                continue

            trace_count, unstarted, counts = _trace_and_commit_wave_sharded(
                committer, init, stage, vs, fields, bp, bd, bi, bv, key, cfg, pos, sel, trace_count,
                stage_iters, lanes,
                # capacity structurally cannot bind when every trace of the
                # wave fits one shard's lanes (lanes = 2*wave >= 2*len(sel)):
                # the stale-by-one kill of the pipeline is then economy-only
                # and results are bitwise the serial loop's
                pipelined=(_lanes_override is None and lanes >= 2 * len(sel)),
            )
            for k, v in counts.items():
                totals[k] += v
            # cap-cut wave tail goes BEFORE earlier lane-overflow re-queues:
            # in an uninterrupted run those overflow seeds trace in the wave
            # AFTER this one
            pending = unstarted + pending
            waves_done += 1
            if (checkpoint_path and waves_done % max(1, checkpoint_every_waves) == 0
                    and mesh.rank == 0):  # one writer: the state is the same everywhere
                save_checkpoint(checkpoint_path, committer, idx, trace_count, pending, nseeds)
    finally:
        drop_graphs(trackers, mesh, fields)  # this stack's graphs are done
    fields = vs = None
    tm.stop()
    if verbose:
        extra = f", {totals['requeued']} re-queued" if totals["requeued"] else ""
        print(f"traced {trace_count} seeds{extra}, {totals['handoffs']} handoffs, "
              f"|n0|={len(nodes)}")

    midres = None
    if cfg.save_midres:
        # the single-device path's artifact set: direction maps, trace
        # density, normalized soma map; reconstruct_graph adds the n0/n1/n2
        # snapshots
        midres = {
            "vx": _fetch_map(vx),
            "vy": _fetch_map(vy),
            "vz": _fetch_map(vz),
            "trace_density": np.clip(committer.npervol, 0, 255).astype(np.uint8),
        }
        if smap is not None:
            midres["smap8"] = smap_to_u8(smap)

    if j8_np is None:
        tm.start("gather J8")
        j8_np = _fetch_map(j8)
        j8 = None
        tm.stop()

    tm.start("reconstruct")
    tree = reconstruct_graph(nodes.copy(), cfg, dev0, midres=midres)
    tm.stop()

    result = ReconstructionResult(
        tree=tree, n0=nodes, seeds_pos=pos, seeds_corr=corr, trace_count=trace_count,
        timings=tm.timings, j8=j8_np, midres=midres, n_raw_seeds=n_raw_seeds,
        zncc_mode=cfg.zncc_mode, n_handoffs=totals["handoffs"], n_requeued=totals["requeued"],
        n_kept_local=totals["kept_local"], n_lost=totals["lost"],
        received_bytes=tm.received if mesh.multiprocess else None,
    )
    warn = low_signal_diagnostic(result)
    if warn is not None:
        sys.stderr.write(f"WARNING low-signal: {warn['message']}\n")
    return result


class _MeteredTimer(StageTimer):
    """`StageTimer` that also records, per stage, the bytes this process
    received from other processes (`multihost.RECEIVED_BYTES`)."""

    def __init__(self, verbose, devices):
        super().__init__(verbose, devices)
        self.received = {}
        self._b0 = 0

    def start(self, name: str):
        self._b0 = multihost.RECEIVED_BYTES
        super().start(name)

    def stop(self):
        super().stop()
        got = multihost.RECEIVED_BYTES - self._b0
        self.received[self._name] = self.received.get(self._name, 0) + got


def _trace_and_commit_wave_sharded(committer, init, stage, vs, fields, bp, bd, bi, bv, base_key,
                                   cfg, pos, sel, trace_count, stage_iters, lanes_per_shard,
                                   pipelined=False):
    """Staged sharded wave with the in-order commit wavefront and
    kill-back, the sharded counterpart of the single-device
    `_trace_and_commit_wave`: estimates commit in seed order between
    stages, and traces whose committed prefix stopped are killed so they
    cost no further device work and free their lanes for migration.

    Every stage runs stage_iters iterations (JAX's shape,
    `pnr_tpu/pipeline/sharded_reconstruct.py:835-837`); the rows at or past
    ni are dropped where the estimates are stitched (`fill_est`).

    With `pipelined`, stage k+1 is launched before stage k's estimates are
    committed, so the host commit overlaps the devices' next stage; its
    kill mask is then one stage stale: economy-only, provided migration
    capacity never binds (the caller's condition), so the results are
    bitwise the serial loop's.

    Returns (trace_count, unstarted seeds, counts): the wave's handoffs (a
    live trace seen on another shard than at the stage before; a lane's
    shard is lane // lanes_per_shard, from the layout), traces kept local
    over its stages, and traces lost (the committer reached an iteration
    whose estimates never arrived: zero by the capacity handshake)."""
    ni = cfg.ni
    state, e0, ids_cur, field = init(vs, bp, bd, bi, bv, base_key, fields)
    shard_of: dict = {}
    counts = {"handoffs": 0, "kept_local": 0, "lost": 0}

    def note_ids(ids_np):
        for lane in np.nonzero(ids_np >= 0)[0]:
            t, s = int(ids_np[lane]), int(lane) // lanes_per_shard
            prev = shard_of.get(t)
            if prev is not None and prev != s:
                counts["handoffs"] += 1
            shard_of[t] = s

    # per-trace host-side estimate buffers, filled stage by stage; `got`
    # is how many leading iterations of each have arrived
    est = {int(t): np.zeros((ni, 9), np.float32) for t in bi[bv]}
    got = {t: 0 for t in est}
    note_ids(ids_cur)
    for lane in np.nonzero(ids_cur >= 0)[0]:
        t = int(ids_cur[lane])
        est[t][0] = e0[lane]
        got[t] = 1

    cursors = {int(t): committer.begin_trace() for t in bi[bv]}
    killed_ids = set()
    lost_ids = set()
    seed_started = {int(s): False for s in sel}
    commit_order = []
    for s in sel:
        commit_order.extend([2 * int(s), 2 * int(s) + 1])
    commit_ptr = 0
    it_done = 1

    def _unstarted():
        # seeds the trace cap prevented from starting: carried as
        # pending by the caller so a checkpointed resume never skips them
        return [int(s) for s in sel if not seed_started[int(s)]]

    def advance(avail):
        nonlocal commit_ptr, trace_count
        while commit_ptr < len(commit_order):
            tid = commit_order[commit_ptr]
            si = tid // 2
            if tid % 2 == 0 and not seed_started[si]:
                if trace_count > cfg.max_trace_count:
                    return True
                seed_started[si] = True
                if not committer.seed_allowed(pos[si]):
                    killed_ids.add(tid)
                    killed_ids.add(tid + 1)
                    if tid in cursors:
                        cursors[tid]["finished"] = True
                    if tid + 1 in cursors:
                        cursors[tid + 1]["finished"] = True
                    commit_ptr += 2
                    continue
                trace_count += 1
            if tid not in cursors:  # seed re-queued out of this wave
                commit_ptr += 1
                continue
            cur = cursors[tid]
            if not cur["finished"] and got[tid] < min(avail, ni) and tid not in lost_ids:
                lost_ids.add(tid)
                counts["lost"] += 1
            e = est[tid]
            committer.commit_steps(cur, e[:, 0:3], e[:, 3:6], e[:, 6], e[:, 7], e[:, 8], avail)
            if cur["finished"] or cur["i"] >= ni:
                committer.finish_trace(cur)
                killed_ids.add(tid)
                commit_ptr += 1
            else:
                break
        return False

    def fill_est(pk, ids_np, it0, n_it):
        for lane in np.nonzero(ids_np >= 0)[0]:
            t = int(ids_np[lane])
            if t in est:
                est[t][it0: it0 + n_it] = pk[lane, :n_it]
                if got[t] == it0:
                    got[t] = it0 + n_it

    def launch(it0):
        """Iterations [it0, it0 + stage_iters) of every lane (JAX's stage
        shape, past ni too), killed in the lane layout of the last launched
        stage: (the stage's outputs, how many of its rows lie below ni)."""
        killed = np.fromiter(killed_ids, np.int64, len(killed_ids))
        out = stage(field, state, range(it0, it0 + stage_iters), np.isin(ids_now[0], killed))
        counts["kept_local"] += int(out[4].sum())
        ids_now[0] = out[2]
        return out, min(stage_iters, ni - it0)

    ids_now = [ids_cur]  # the lane ids of the last launched stage
    if not pipelined:
        while True:
            capped = advance(it_done)
            if commit_ptr >= len(commit_order) or it_done >= ni or capped:
                break
            # the kill mask in the CURRENT lane layout
            (state, packed, ids_cur, _, _), n_it = launch(it_done)
            note_ids(ids_cur)
            fill_est(lane_estimates(packed, lanes_per_shard, stage_iters), ids_cur, it_done, n_it)
            it_done += n_it
        advance(it_done)
        return trace_count, _unstarted(), counts

    # ---- pipelined: one stage in flight ahead of the commit wavefront
    it_launch = 1
    inflight = None  # (packed, ids, it_start, n_it)
    while True:
        capped = advance(it_done)
        if commit_ptr >= len(commit_order) or capped:
            break  # in-flight work (if any) is dead — drop it
        if it_launch < ni:
            (state, packed, ids_j, _, _), n_it = launch(it_launch)
            newflight = (packed, ids_j, it_launch, n_it)
            it_launch += n_it
        else:
            newflight = None
        if inflight is not None:
            packed_p, ids_np, it0, n_p = inflight
            note_ids(ids_np)
            fill_est(lane_estimates(packed_p, lanes_per_shard, stage_iters), ids_np, it0, n_p)
            it_done = it0 + n_p
        elif newflight is None:
            break
        inflight = newflight

    advance(it_done)
    return trace_count, _unstarted(), counts
