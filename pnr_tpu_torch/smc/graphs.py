"""CUDA graphs of the single-stack tracer's stages.

The counterpart of JAX's jitted stage (`pnr_tpu/smc/tracker.py:172-173`,
`jax.jit(stage_fn)`, the body at `:385`): JAX compiles a stage once into
one executable, Threefry draws included. The port's stage is
`BatchedTracker._stage_body`, whose iterations issue ~90-280 torch ops and
kernel launches each from Python; on a card
`pipeline.reconstruct._trace_and_commit_wave` hands each stage of a wave
to `StageGraphs`, which captures the body once per key and replays it.
The module has no JAX counterpart module.

* Keys: one graph per (chunk slot, T, n_it) within one field. A wave of
  256 traces fills two slots of T=128; a later wave of 90 traces reuses
  slot 0 at T=90. Binding another field (the next stack of a batch) drops
  every graph, buffer and route of the last one.
* Static buffers, per (slot, T): the six carry tensors, the uniforms `u1`
  (STAGE_ITERS, T, np) and `ru` (STAGE_ITERS, T) (a stage of n_it
  iterations reads their first n_it rows) and the kill mask (T,). A graph
  reads them and ends by copying the new carry back into the carry
  buffers, so replays chain. `load` copies `trace_init`'s carry in once a
  wave.
* Copies: the uniforms are drawn on the host (`stage_uniforms`, bitwise
  JAX's) and go in, with the kill mask, through one of two pinned staging
  sets per slot (a stage is dispatched before the previous one is
  collected), with `non_blocking=True`; the stage's `packed` goes out to
  one of two pinned host buffers per slot, read after an event. No copy
  synchronises a stream: a pageable copy would, and the wave loop's
  "dispatch stage k+1 before collecting k" would then wait for stage k.
* Routes (`StagePlan`): a key's first stage runs eagerly (the warm-up a
  capture needs: K2's shared-memory attribute, the kernels' constants and
  window tables, cuBLAS's workspace on the runner's stream), its second is
  captured and replayed, every later one replays. A key that runs once
  (a chunk's last, shorter stage) is never captured.
* Stream: every stage runs on the runner's own stream (a capture cannot
  run on the legacy default stream, and the warm-up runs where the
  capture will); `load` and `finish` order it against the caller's
  stream. Captures use `capture_error_mode="thread_local"`: the batch
  driver's prefetch workers launch fronts on their own streams meanwhile.
* Launch counts: capturing runs the wrappers, which count launches that
  do not happen. The tracer tallies its own kernel calls while its thread
  captures (`tally_launch`; another thread's launches meanwhile are real
  and stay counted), `_take_back` subtracts the tally, and every replay
  adds it (`_count_replay`), under `ops.cuda.COUNT_LOCK`: a run's counts
  equal the eager route's.
* Errors: a capture or replay that fails raises with its key and CUDA's
  error. Nothing falls back to the eager stage.

One thread traces with a tracker at a time, as with the eager stages.
"""

from __future__ import annotations

import threading
import weakref
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from pnr_tpu_torch.ops import cuda

#: stage graphs replayed; each replay adds its graph's launches to the
#: kernels' counters
REPLAYS = 0
#: stage graphs captured
CAPTURES = 0

EAGER, CAPTURE, REPLAY = "eager", "capture", "replay"

Key = Tuple[int, int, int]  # (chunk slot, T, n_it)
Counter = Tuple[object, str]  # (module, name of its launch counter)


class StagePlan:
    """The route of each stage of one field, by key: EAGER the first time
    a key runs, CAPTURE (then replay) the second, REPLAY after that."""

    def __init__(self):
        self.seen: Dict[Key, int] = {}

    def route(self, key: Key) -> str:
        n = self.seen.get(key, 0)
        self.seen[key] = n + 1
        return EAGER if n == 0 else CAPTURE if n == 1 else REPLAY


class _Tally(threading.local):
    counts: Optional[Dict[Counter, int]] = None


_TALLY = _Tally()


def tally_launch(counter: Counter) -> None:
    """Note one kernel launch on `counter`, if this thread is capturing."""
    counts = _TALLY.counts
    if counts is not None:
        counts[counter] = counts.get(counter, 0) + 1


def _add_launches(launches: Dict[Counter, int], sign: int) -> None:
    for (module, name), n in launches.items():
        setattr(module, name, getattr(module, name) + sign * n)


def _take_back(launches: Dict[Counter, int]) -> None:
    """A capture counted `launches` that it did not make: take them back."""
    global CAPTURES
    with cuda.COUNT_LOCK:
        _add_launches(launches, -1)
        CAPTURES += 1


def _count_replay(launches: Dict[Counter, int]) -> None:
    """A replay launched its graph's kernels: count them."""
    global REPLAYS
    with cuda.COUNT_LOCK:
        _add_launches(launches, 1)
        REPLAYS += 1


class _Graph:
    """A captured stage: the graph, its static `packed` output, and the
    launches each replay makes."""

    __slots__ = ("graph", "packed", "launches")

    def __init__(self, graph, packed, launches):
        self.graph, self.packed, self.launches = graph, packed, launches


class _Staging:
    """One pinned set of a stage's inputs, and the event after the copies
    that read it."""

    def __init__(self, iters: int, t: int, npart: int):
        self.u1 = torch.empty((iters, t, npart), dtype=torch.float32, pin_memory=True)
        self.ru = torch.empty((iters, t), dtype=torch.float32, pin_memory=True)
        self.kill = torch.empty((t,), dtype=torch.bool, pin_memory=True)
        self.u1_np, self.ru_np, self.kill_np = self.u1.numpy(), self.ru.numpy(), self.kill.numpy()
        self.copied = torch.cuda.Event()


class _Slot:
    """The static device buffers of one chunk slot at T traces, its two
    pinned staging sets and its two pinned output buffers."""

    def __init__(self, carry, iters: int, npart: int):
        t = int(carry[0].shape[0])
        dev = carry[0].device
        self.iters = iters
        self.carry = tuple(torch.empty_like(c) for c in carry)
        self.u1 = torch.empty((iters, t, npart), dtype=torch.float32, device=dev)
        self.ru = torch.empty((iters, t), dtype=torch.float32, device=dev)
        self.kill = torch.empty((t,), dtype=torch.bool, device=dev)
        self.staging = [_Staging(iters, t, npart) for _ in range(2)]
        self.outs = [torch.empty((t * iters * 9,), dtype=torch.float32, pin_memory=True)
                     for _ in range(2)]
        self.turn = 0


class PendingStage:
    """A dispatched stage's `packed` on its way to the host."""

    __slots__ = ("out", "done")

    def __init__(self, out: torch.Tensor, done: torch.cuda.Event):
        self.out, self.done = out, done

    def numpy(self) -> np.ndarray:
        """(T, n_it, 9) packed estimates, once the stage has run."""
        self.done.synchronize()
        return self.out.numpy().copy()


class StageGraphs:
    """The stage-graph runner of one tracker on a card (see the module
    docstring). `bind(field)`, then per wave `load` each slot's carry,
    `stage` each stage and `finish`."""

    def __init__(self, tracker):
        # the tracker owns its runner: a strong reference back would keep
        # both, and the graphs' device memory, alive until a cyclic GC
        self.tracker = weakref.proxy(tracker)
        self.stream: Optional[torch.cuda.Stream] = None
        self._field = None
        self._reset()

    def _reset(self):
        self.plan = StagePlan()
        self.slots: Dict[Tuple[int, int], _Slot] = {}
        self.graphs: Dict[Key, _Graph] = {}
        #: stages by route, for this field
        self.routes = {EAGER: 0, CAPTURE: 0, REPLAY: 0}
        #: the caching allocator's reserved bytes added while capturing
        #: (other threads' allocations meanwhile included)
        self.reserved_bytes = 0

    def bind(self, field: torch.Tensor) -> None:
        """Trace on `field` from now on; a new field drops the old graphs."""
        if self._field is not None and self._field() is field:
            return
        if self.stream is None:
            self.stream = torch.cuda.Stream(field.device)
        else:
            # nothing may still replay into the memory the graphs release
            self.stream.synchronize()
        self._reset()
        self._field = weakref.ref(field)
        field.record_stream(self.stream)

    def load(self, slot: int, carry) -> None:
        """Copy `trace_init`'s carry of chunk `slot` into the slot's
        buffers (once a wave)."""
        tr = self.tracker
        key = (slot, int(carry[0].shape[0]))
        s = self.slots.get(key)
        if s is None:
            s = self.slots[key] = _Slot(carry, tr.STAGE_ITERS, tr.cfg.np)
        self.stream.wait_stream(torch.cuda.current_stream(self.stream.device))
        with torch.cuda.stream(self.stream):
            for dst, src in zip(s.carry, carry):
                dst.copy_(src)
        for src in carry:
            src.record_stream(self.stream)

    def finish(self) -> None:
        """Order the caller's stream after every stage dispatched so far."""
        torch.cuda.current_stream(self.stream.device).wait_stream(self.stream)

    def stage(self, slot: int, keys: np.ndarray, it0: int, n_it: int,
              kill: np.ndarray) -> PendingStage:
        """Iterations it0 .. it0+n_it-1 of chunk `slot` (its carry
        `load`ed this wave) with the kill mask `kill` (T,) bool: eagerly,
        captured or replayed as `plan` routes its key."""
        field = self._field()
        t = len(kill)
        s = self.slots[(slot, t)]
        if not 1 <= n_it <= s.iters:
            raise ValueError(f"a stage of {n_it} iterations; the slot holds 1 to {s.iters}")
        key = (slot, t, n_it)
        route = self.plan.route(key)
        self.routes[route] += 1
        u1, ru = self.tracker.stage_uniforms(keys, it0, n_it)
        st = s.staging[s.turn]
        out = s.outs[s.turn][: t * n_it * 9].view(t, n_it, 9)
        s.turn ^= 1
        st.copied.synchronize()  # the copies that last read this set have run
        st.u1_np[:n_it] = u1
        st.ru_np[:n_it] = ru
        st.kill_np[:] = kill
        with torch.cuda.stream(self.stream):
            s.u1[:n_it].copy_(st.u1[:n_it], non_blocking=True)
            s.ru[:n_it].copy_(st.ru[:n_it], non_blocking=True)
            s.kill.copy_(st.kill, non_blocking=True)
            st.copied.record()
            if route == EAGER:
                packed = self._run(field, s, n_it)
            else:
                if route == CAPTURE:
                    self.graphs[key] = self._capture(key, field, s, n_it)
                packed = self._replay(key)
            out.copy_(packed, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        return PendingStage(out, done)

    def _run(self, field, s: _Slot, n_it: int) -> torch.Tensor:
        carry, packed = self.tracker._stage_body(field, s.carry, s.u1[:n_it], s.ru[:n_it],
                                                 s.kill, n_it)
        for dst, src in zip(s.carry, carry):
            dst.copy_(src)
        return packed

    def _capture(self, key: Key, field, s: _Slot, n_it: int) -> _Graph:
        graph = torch.cuda.CUDAGraph()
        launches: Dict[Counter, int] = {}
        before = torch.cuda.memory_reserved(self.stream.device)
        _TALLY.counts = launches
        try:
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                packed = self._run(field, s, n_it)
            finally:
                graph.capture_end()
        except RuntimeError as e:
            raise RuntimeError(f"capturing the tracer stage (slot, T, n_it) = {key} failed: "
                               f"{e}") from e
        finally:
            _TALLY.counts = None
        _take_back(launches)
        self.reserved_bytes += torch.cuda.memory_reserved(self.stream.device) - before
        return _Graph(graph, packed, launches)

    def _replay(self, key: Key) -> torch.Tensor:
        g = self.graphs[key]
        try:
            g.graph.replay()
        except RuntimeError as e:
            raise RuntimeError(f"replaying the tracer stage (slot, T, n_it) = {key} failed: "
                               f"{e}") from e
        _count_replay(g.launches)
        return g.packed
