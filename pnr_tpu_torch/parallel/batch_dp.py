"""Data parallelism over stacks: one stack a device of a mesh.

Port of pnr_tpu/parallel/batch_dp.py. `reconstruction_batch_dp` runs a
batch of equal-shape stacks, stack i on `mesh.devices[i]`: each stack's
front (soma, the unfused filter and J8, the seed flood, the likelihood
field, seed scoring) on its device, and the tracing waves of all stacks in
lockstep, one stage launch per stack and step, the host committing each
stack's estimates between steps with the single-device pipeline's
first-come-first-served wavefront. The graph stages run per stack on the
host. Stack i traces with the key fold_in(key, i) and each trace with
fold_in(stack key, trace id), the streams of `reconstruction_batch`, so
the node graphs equal the sequential runs' under the same filter.

A wave has JAX's shapes (`pnr_tpu/parallel/batch_dp.py:230-315`,
`:357-366`): each stack's 2 * wave_size lanes, the lanes past its wave's
traces dead from the start (position zero, direction +x, trace id 0) and
never committed, and every stage STAGE_ITERS iterations, of which the
rows below ni are kept. So every stage of a stack has one shape, and on a
card it replays as a CUDA graph (smc/graphs.py): each stack's field has
its runner, which captures at the stack's first stage, as JAX compiles its
jitted stage at its first call, and is dropped when its group's tracing
ends.

JAX's batch filter is the unfused `frangi3d` whatever `cfg.fused_frangi`
says (`build_batch_filter`); so is the port's (`batch_filter`: K4 and K3,
or `frangi2d` on K3 for a one-plane stack). A batch larger than the mesh
runs in mesh-size groups, each stack keeping its global index for its
key; JAX pads a short batch with discarded copies of stack 0, the port
leaves the spare devices idle. The fronts of stacks on distinct cards run
on one host thread per card; a virtual mesh (every shard on `cuda:0`)
runs them one after another.

`split_mesh` and `reconstruction_batch_sharded` compose both axes: the
mesh splits into equal groups, and each group runs the sharded pipeline
(`reconstruction_func_sharded`) on the next stack on its own host
thread, with its own CUDA stream on each of its cards, so that groups
sharing a card (a virtual mesh) still overlap.
"""

from __future__ import annotations

import contextlib
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np
import torch

from pnr_tpu_torch.config import PNRConfig
from pnr_tpu_torch.graph.build import TraceCommitter
from pnr_tpu_torch.hostpath import threefry as tf
from pnr_tpu_torch.io.volume import as_u8_volume
from pnr_tpu_torch.ops.frangi import frangi3d
from pnr_tpu_torch.ops.frangi_blocked import frangi3d_blocked, frangi3d_tiled
from pnr_tpu_torch.parallel.sharded import Mesh, on, slab_filter_route
from pnr_tpu_torch.pipeline import reconstruct as rc
from pnr_tpu_torch.pipeline.reconstruct import (
    ReconstructionResult,
    _stack_front,
    reconstruct_graph,
)
from pnr_tpu_torch.ops.threefry import key_tensor
from pnr_tpu_torch.smc.tracker import BatchedTracker, trace_keys
from pnr_tpu_torch.utils.runtime import require_cuda
from pnr_tpu_torch.utils.spans import StageTimer


def batch_filter(img: torch.Tensor, cfg: PNRConfig):
    """The batch's filter (JAX's `build_batch_filter`): the unfused filter
    whatever `cfg.fused_frangi` or PNR_TPU_FUSED_FRANGI says, routed as the
    single-device pipeline routes it with `fused_frangi=False` (the
    monolithic `frangi3d` under UNFUSED_MAX_VOXELS, else the tiled engines,
    bitwise the same); a one-plane stack runs `frangi2d`."""
    if img.shape[0] == 1:
        return rc._frangi(img, cfg)  # a plane's route has no K1
    args = (img, cfg.sigmas, cfg.zdist, cfg.frangi_alpha, cfg.frangi_beta, cfg.frangi_c)
    route = slab_filter_route(img.shape, cfg.sigmas, cfg.zdist,
                              tiled=img.numel() > rc.UNFUSED_MAX_VOXELS)
    if not route.tiled:
        return frangi3d(*args)
    if route.blocks is not None:
        return frangi3d_tiled(*args, block_z=route.blocks[0], block_y=route.blocks[1])
    return frangi3d_blocked(*args)


def _check_mesh(mesh: Mesh, device) -> torch.device:
    """Resolve `device` and hold every shard of `mesh` to its type (and to
    this process: a batch does not span processes)."""
    if mesh.multiprocess:
        raise ValueError("a batch over a mesh runs in one process; this mesh spans several")
    dev = require_cuda(device)
    if any(d.type != dev.type for d in mesh.devices):
        raise ValueError(f"the mesh's devices {mesh.devices} are not all of type {dev.type!r} "
                         f"(device={device!r})")
    return dev


class _StackWave:
    """One stack's wave in the lockstep tracer: its `lanes` lanes [pos_0,
    neg_0, pos_1, neg_1, ..., dead pad lanes] on its device (in the
    field's stage-graph runner on a card), the real lanes' host estimates,
    and the in-order commit wavefront (the single-device
    `_trace_and_commit_wave`'s rule, JAX's `advance`)."""

    def __init__(self, tracker, field, committer, pos, dirs, sel, stack_key, cfg, trace_count,
                 lanes):
        self.tracker, self.field, self.committer, self.cfg = tracker, field, committer, cfg
        self.pos, self.sel, self.trace_count = pos, sel, trace_count
        self.t_real = t_real = 2 * len(sel)
        sp = np.zeros((lanes, 3), np.float32)
        sd = np.zeros((lanes, 3), np.float32)
        sd[:, 0] = 1.0
        ids = np.zeros(lanes, np.int64)
        sp[:t_real] = np.repeat(pos[sel], 2, axis=0)
        sd[0:t_real:2] = dirs[sel]
        sd[1:t_real:2] = -dirs[sel]
        ids[0:t_real:2] = 2 * sel
        ids[1:t_real:2] = 2 * sel + 1
        # on the stack's device once; each stage draws from them there
        self.keys = key_tensor(trace_keys(stack_key, ids), field.device)
        self.runner = tracker.stage_graphs(field)  # None: eager stages
        with on(field.device):
            self.carry, self._est0 = tracker.trace_init(field, sp, sd, self.keys)
            if self.runner is not None:
                self.runner.load(0, self.carry, self.keys)
                self.carry = None
        self.est = np.zeros((t_real, cfg.ni, 9), np.float32)
        self.cursors = [committer.begin_trace() for _ in range(t_real)]
        self.killed = np.zeros(lanes, bool)
        self.killed[t_real:] = True  # pad lanes never commit
        self.started = np.zeros(len(sel), bool)
        self.ptr = 0
        self.capped = False

    def collect_init(self):
        self.est[:, 0] = self._est0.cpu().numpy()[:self.t_real]
        self._est0 = None

    @property
    def done(self) -> bool:
        return self.capped or self.ptr >= len(self.cursors)

    def advance(self, avail: int) -> None:
        """Commit in trace order up to iteration `avail`; a started seed
        finishes both directions, the cap stops starting seeds."""
        cfg, com = self.cfg, self.committer
        while self.ptr < len(self.cursors):
            k, si = self.ptr, self.ptr // 2
            if k % 2 == 0 and not self.started[si]:
                if self.trace_count > cfg.max_trace_count:
                    self.capped = True
                    return
                self.started[si] = True
                if not com.seed_allowed(self.pos[self.sel[si]]):
                    self.killed[k] = self.killed[k + 1] = True
                    self.ptr += 2
                    continue
                self.trace_count += 1
            cur, e = self.cursors[k], self.est[k]
            com.commit_steps(cur, e[:, 0:3], e[:, 3:6], e[:, 6], e[:, 7], e[:, 8], avail)
            if cur["finished"] or cur["i"] >= cfg.ni:
                com.finish_trace(cur)
                self.killed[k] = True
                self.ptr += 1
            else:
                return

    def launch(self, it0: int):
        """Iterations [it0, it0 + STAGE_ITERS) of every lane, the killed ones
        retired: replayed in the runner on a card, else eager. Returns a
        fetch of the (lanes, STAGE_ITERS, 9) host estimates (None when all
        are killed)."""
        if self.killed.all():
            return None
        if self.runner is not None:
            return self.runner.stage(0, it0, self.killed).numpy
        dev = self.field.device
        with on(dev):
            kill = torch.from_numpy(self.killed.copy()).to(dev)
            self.carry, packed = self.tracker.trace_stage(
                self.field, self.keys, self.carry, it0, self.tracker.STAGE_ITERS, kill)
        return lambda: packed.cpu().numpy()


def reconstruction_batch_dp(
    vols,
    cfg: PNRConfig,
    mesh: Mesh,
    verbose: bool = False,
    key: Optional[np.ndarray] = None,
    _key_offset: int = 0,
    *,
    device="cuda",
) -> List[ReconstructionResult]:
    """Reconstruct equal-shape stacks, stack i on `mesh.devices[i]`, in
    mesh-size groups; results in input order, each equal to
    `reconstruction_batch`'s under `fused_frangi=False` with the same
    `key` (default: the key of `cfg.seed`). `device` is the mesh's type
    ("cuda" unless the caller asks for the CPU; without a card it raises).
    `cfg.save_midres` is not collected here, as in JAX."""
    dev_type = _check_mesh(mesh, device)
    vols = [as_u8_volume(v) for v in vols]
    if not vols:
        return []
    shape = vols[0].shape
    if any(v.shape != shape for v in vols):
        raise ValueError("reconstruction_batch_dp requires equal-shape stacks")
    if key is None:
        key = tf.key_from_seed(cfg.seed)
    n_dev = mesh.size
    if len(vols) > n_dev:
        out = []
        for beg in range(0, len(vols), n_dev):
            out.extend(reconstruction_batch_dp(vols[beg:beg + n_dev], cfg, mesh, verbose,
                                               key=key, _key_offset=_key_offset + beg,
                                               device=dev_type))
        return out
    nb = len(vols)
    devices = list(mesh.devices[:nb])
    is2d = shape[0] == 1
    trackers: Dict[torch.device, BatchedTracker] = {}
    for d in devices:
        if d not in trackers:
            with on(d):
                trackers[d] = BatchedTracker(cfg, d, is2d=is2d)

    def front(i):
        with on(devices[i]):
            return _stack_front(vols[i], cfg, devices[i], verbose=verbose,
                                tracker=trackers[devices[i]], frangi=batch_filter, warm=False)

    # the fronts: one host thread per distinct card, a card's stacks in turn
    by_dev: Dict[torch.device, List[int]] = {}
    for i, d in enumerate(devices):
        by_dev.setdefault(d, []).append(i)
    fronts = [None] * nb
    if len(by_dev) == 1:
        for i in range(nb):
            fronts[i] = front(i)
    else:
        def run(idx):
            for i in idx:
                fronts[i] = front(i)

        with ThreadPoolExecutor(max_workers=len(by_dev)) as ex:
            for f in [ex.submit(run, idx) for idx in by_dev.values()]:
                f.result()

    tm = StageTimer(verbose, devices)
    tm.start("tracing (batch, lockstep waves)")
    wave = max(1, cfg.wave_size)
    lanes = 2 * wave
    ni = cfg.ni
    stage_iters = trackers[devices[0]].STAGE_ITERS
    committers = [TraceCommitter(shape, cfg.vol, cfg.nodepervol, f.nodes, f.smap) for f in fronts]
    stack_keys = [tf.fold_in(key, _key_offset + i) for i in range(nb)]
    idxs = [0] * nb
    trace_counts = [0] * nb

    def next_wave(i):
        """Stack i's next wave of allowed seeds (None when it is done)."""
        pos = fronts[i].pos
        sel = []
        while idxs[i] < len(pos) and len(sel) < wave:
            if trace_counts[i] > cfg.max_trace_count:
                return None
            if committers[i].seed_allowed(pos[idxs[i]]):
                sel.append(idxs[i])
            idxs[i] += 1
        return np.asarray(sel) if sel else None

    active = list(range(nb))
    try:
        while active:
            waves = {}
            for i in list(active):
                sel = next_wave(i)
                if sel is None:
                    active.remove(i)
                    continue
                f = fronts[i]
                waves[i] = _StackWave(f.tracker, f.field, committers[i], f.pos, f.dirs, sel,
                                      stack_keys[i], cfg, trace_counts[i], lanes)
            for w in waves.values():
                w.collect_init()
            it_done = 1
            while True:
                for w in waves.values():
                    w.advance(it_done)
                if all(w.done for w in waves.values()) or it_done >= ni:
                    break
                n_it = min(stage_iters, ni - it_done)
                # every stack's stage launched before any is read back
                pend = [(w, w.launch(it_done)) for w in waves.values() if not w.done]
                for w, fetch in pend:
                    if fetch is not None:
                        w.est[:, it_done:it_done + n_it] = fetch()[:w.t_real, :n_it]
                it_done += n_it
            for i, w in waves.items():
                w.advance(it_done)
                trace_counts[i] = w.trace_count
    finally:
        for f in fronts:
            f.tracker.drop_stage_graphs(f.field)  # this group's graphs are done
    tm.stop()

    tm.start("reconstruct (batch)")
    trees = [reconstruct_graph(f.nodes.copy(), cfg, devices[i]) for i, f in enumerate(fronts)]
    tm.stop()
    results = []
    for i, f in enumerate(fronts):
        timings = dict(f.timings)
        timings.update(tm.timings)
        results.append(ReconstructionResult(
            tree=trees[i], n0=f.nodes, seeds_pos=f.pos, seeds_corr=f.corr,
            trace_count=trace_counts[i], timings=timings, j8=f.j8_np,
            n_raw_seeds=f.n_raw_seeds, zncc_mode=cfg.zncc_mode))
    return results


def split_mesh(mesh: Mesh, groups: int) -> List[Mesh]:
    """A 1-D mesh split into `groups` equal contiguous submeshes."""
    n_dev = mesh.size
    if groups < 1 or n_dev % groups:
        raise ValueError(f"split_mesh: {groups} groups must divide the {n_dev}-device mesh")
    k = n_dev // groups
    return [Mesh(tuple(mesh.devices[g * k:(g + 1) * k]), mesh.axis,
                 None if mesh.ranks is None else tuple(mesh.ranks[g * k:(g + 1) * k]), mesh.rank)
            for g in range(groups)]


def _own_streams(mesh: Mesh) -> contextlib.ExitStack:
    """A new CUDA stream made current on each card of `mesh` for the calling
    thread (nothing on the CPU)."""
    stack = contextlib.ExitStack()
    for d in dict.fromkeys(mesh.devices):
        if d.type == "cuda":
            stack.enter_context(torch.cuda.stream(torch.cuda.Stream(d)))
    return stack


def reconstruction_batch_sharded(
    vols,
    cfg: PNRConfig,
    mesh: Mesh,
    groups: Optional[int] = None,
    verbose: bool = False,
) -> List[ReconstructionResult]:
    """DP x spatial: the mesh split into `groups` equal submeshes
    (`split_mesh`; default the largest divisor of the mesh size no larger
    than the batch), each running `reconstruction_func_sharded` on the next
    stack on its own host thread and CUDA streams. Results in input order,
    each equal to `reconstruction_func_sharded` on a same-size mesh (a
    stack's streams derive from `cfg.seed` alone). A group's exception
    propagates once every group has stopped."""
    from pnr_tpu_torch.pipeline.sharded_reconstruct import reconstruction_func_sharded

    if mesh.multiprocess:
        raise ValueError("a batch over a mesh runs in one process; this mesh spans several")
    vols = [as_u8_volume(v) for v in vols]
    if not vols:
        return []
    n_dev = mesh.size
    if groups is None:
        groups = max(g for g in range(1, min(len(vols), n_dev) + 1) if n_dev % g == 0)
    submeshes = split_mesh(mesh, groups)
    todo: "queue.SimpleQueue[int]" = queue.SimpleQueue()
    for i in range(len(vols)):
        todo.put(i)
    results: List[Optional[ReconstructionResult]] = [None] * len(vols)
    errors: List[BaseException] = []

    def worker(g: int):
        try:
            with _own_streams(submeshes[g]):
                while not errors:
                    try:
                        i = todo.get_nowait()
                    except queue.Empty:
                        return
                    results[i] = reconstruction_func_sharded(vols[i], cfg, submeshes[g],
                                                             verbose=verbose)
        except BaseException as e:  # re-raised on the caller's thread below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(g,), name=f"pnr-group-{g}")
               for g in range(groups)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results  # type: ignore[return-value]
