"""CUDA graphs of the tracers' stages.

The counterpart of JAX's jitted stage (`pnr_tpu/smc/tracker.py:172-173`,
`jax.jit(stage_fn)`, the body at `:385`) and of its `warm_async`
(`:180-221`): JAX compiles a stage once into one executable, Threefry
draws included, and builds it on a worker thread while the front of the
stack runs. The port's stage is `BatchedTracker._stage_body`, which
draws its uniforms on the device (one launch of ops/threefry's kernel)
and whose iterations issue ~90-280 torch ops and kernel launches each
from Python; on a card the tracers hand each stage to `StageGraphs`,
which captures the body once per key and replays it: the single-stack
wave loop (`pipeline.reconstruct._trace_and_commit_wave`), batch DP's
lockstep waves (`parallel/batch_dp.py`, JAX's jitted `build_batch_tracer`
stage) and each local shard of the handoff tracer (`parallel/handoff.py`,
JAX's jitted `build_handoff_tracer` stage). The module has no JAX
counterpart module.

* Keys: one graph per (chunk slot, T, n_it) within one field. The
  tracers run JAX's shapes, every stage at STAGE_ITERS iterations: the
  single stack pads every chunk to TRACE_CHUNK traces, so a wave of 256
  traces uses the keys (0, 128, S) and (1, 128, S); batch DP gives each
  stack one slot of 2 * wave_size lanes and the handoff tracer each shard
  one slot of its lanes. Every later wave of the field reuses its keys. A
  runner belongs to one field (`tracker.stage_graphs`), and to the
  field's `SlabFrame` where a shard traces its slab: the frame is fixed
  for the field, so each capture freezes it into the graph. The tracker
  drops the runner when that stack's tracing ends.
* Static buffers, per (slot, T): the six carry tensors, the trace keys
  (T, 2) int32, the stage's first iteration `it0` (an int32 scalar) and
  the kill mask (T,). A graph reads them and ends by copying the new
  carry back into the carry buffers, so replays chain. `load` copies
  `trace_init`'s carry and the chunk's keys in once a wave. The draws'
  kernel reads `it0` and the keys from these buffers at each replay (an
  `it0` passed by value would be frozen into the graph at capture).
  Between stages a caller may write a slot's carry and keys in place
  (`buffers`, inside `writing`): the handoff tracer seats arriving traces
  in free lanes so.
* Copies: no uniform crosses from the host; the stage's kill mask and
  `it0` go in through one of two pinned staging sets per slot (a stage is
  dispatched before the previous one is collected), with
  `non_blocking=True`; the stage's `packed` goes out to one of two pinned
  host buffers per slot, read after an event. No copy synchronises a
  stream: a pageable copy would, and the wave loop's "dispatch stage k+1
  before collecting k" would then wait for stage k.
* Routes (`StagePlan`): a key is captured the first time it runs and
  replayed at once, and every later stage replays. Before each capture
  `BatchedTracker.prepare_graphs` sets up, on the capturing thread and the
  runner's stream, the lazy state a capture must not create: the kernel
  library and its entry points, cuBLAS's workspace (one matmul of the
  stage's shapes), K2's shared-memory attribute and cluster check for the
  field's plans, and the tube engine's window table and kernel constants
  (under the runner's frame). The mesh tracers capture a key at its first
  stage, as JAX compiles at its first call; only the single stack warms.
* Warm thread (`warm`, started by `BatchedTracker.warm_async`): while the
  front of the stack runs, it runs `trace_init` on JAX's dummy seeds,
  loads that carry into each slot a full wave fills and captures each
  slot's key, so the tracing thread only replays. It works on the
  runner's stream after an event recorded behind the field's last write;
  the wave loop joins it (`join_warm`) before its first stage and raises
  its exception there. Its captures pass the tracker's `CaptureGate`,
  which the batch driver closes while its caller runs.
* Stream: every stage runs on the runner's own stream (a capture cannot
  run on the legacy default stream); `load` and `finish` order it against
  the caller's stream. Captures use `capture_error_mode="thread_local"`:
  the batch driver's prefetch workers launch fronts on their own streams
  meanwhile, the tracing thread replays another field's graphs while
  a warm thread captures, and `reconstruction_batch_sharded`'s group
  threads capture their shards' graphs on one card at once (none of them
  synchronises the whole device while it traces).
* Launch counts: capturing runs the wrappers, which count launches that
  do not happen. The tracer tallies its own kernel calls (the likelihood
  and the draws) while its thread captures (`tally_launch`; another
  thread's launches meanwhile are real and stay counted), `_take_back`
  subtracts the tally, and every replay adds it (`_count_replay`), under
  `ops.cuda.COUNT_LOCK`: a run's counts equal the eager route's, plus the
  warm thread's real `trace_init`.
* Host time: `host_s` sums the tracing thread's seconds in the runner's
  own calls for the stages it dispatched, split into the staging writes
  and copies, the replay calls and the waits for each stage's estimates.
* Errors: a capture or replay that fails raises with its key and CUDA's
  error. Nothing falls back to the eager stage.

One thread traces on a runner at a time.
"""

from __future__ import annotations

import contextlib
import threading
import time
import weakref
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from pnr_tpu_torch.ops import cuda

#: stage graphs replayed; each replay adds its graph's launches to the
#: kernels' counters
REPLAYS = 0
#: stage graphs captured (by the tracing thread or a warm thread)
CAPTURES = 0
#: stage graphs captured by a warm thread (`StageGraphs.warm`)
WARM_CAPTURES = 0

CAPTURE, REPLAY = "capture", "replay"

Key = Tuple[int, int, int]  # (chunk slot, T, n_it)
Counter = Tuple[object, str]  # (module, name of its launch counter)


class StagePlan:
    """The route of each stage of one field, by key: CAPTURE (then
    replay) the first time a key runs, REPLAY after that."""

    def __init__(self):
        self.seen = set()

    def route(self, key: Key) -> str:
        if key in self.seen:
            return REPLAY
        self.seen.add(key)
        return CAPTURE


class CaptureGate:
    """When a tracker's warm threads may capture. A CUDA graph capture on
    one thread fails, together with the other thread's call, when another
    thread synchronises the whole device meanwhile (`torch.cuda.
    synchronize()`), as a caller of `reconstruction_batch` may while the
    generator waits at a yield and the next stacks' fronts, and their warm
    threads, run on. The batch driver closes the gate before it yields
    (the captures in progress finish first) and opens it when it resumes;
    a warm thread waits at a closed gate before each capture. `cancel`
    ends the waits for good: a capture asked for after it raises."""

    def __init__(self):
        self._cond = threading.Condition()
        self._open = True
        self._cancelled = False
        self._busy = 0

    @contextlib.contextmanager
    def capture(self):
        """Hold the gate open for one capture."""
        with self._cond:
            self._cond.wait_for(lambda: self._open or self._cancelled)
            if self._cancelled:
                raise RuntimeError("the stage-graph captures were cancelled")
            self._busy += 1
        try:
            yield
        finally:
            with self._cond:
                self._busy -= 1
                self._cond.notify_all()

    def close(self) -> None:
        """Start no capture, and wait for those in progress."""
        with self._cond:
            self._open = False
            self._cond.wait_for(lambda: self._busy == 0)

    def open(self) -> None:
        with self._cond:
            self._open = True
            self._cond.notify_all()

    def cancel(self) -> None:
        with self._cond:
            self._cancelled = True
            self._cond.notify_all()


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


def _count_warm_capture() -> None:
    global WARM_CAPTURES
    with cuda.COUNT_LOCK:
        WARM_CAPTURES += 1


class _Graph:
    """A captured stage: the graph, its static `packed` output, and the
    launches each replay makes."""

    __slots__ = ("graph", "packed", "launches")

    def __init__(self, graph, packed, launches):
        self.graph, self.packed, self.launches = graph, packed, launches


class _Staging:
    """One pinned set of a stage's inputs (the kill mask and `it0`), and
    the event after the copies that read it."""

    def __init__(self, t: int):
        self.kill = torch.empty((t,), dtype=torch.bool, pin_memory=True)
        self.it0 = torch.empty((), dtype=torch.int32, pin_memory=True)
        self.kill_np, self.it0_np = self.kill.numpy(), self.it0.numpy()
        self.copied = torch.cuda.Event()


class _Slot:
    """The static device buffers of one chunk slot at T traces, its two
    pinned staging sets and its two pinned output buffers."""

    def __init__(self, carry, iters: int):
        t = int(carry[0].shape[0])
        dev = carry[0].device
        self.iters = iters
        self.carry = tuple(torch.empty_like(c) for c in carry)
        self.keys = torch.empty((t, 2), dtype=torch.int32, device=dev)
        self.it0 = torch.empty((), dtype=torch.int32, device=dev)
        self.kill = torch.empty((t,), dtype=torch.bool, device=dev)
        self.staging = [_Staging(t) for _ in range(2)]
        self.outs = [torch.empty((t, iters, 9), dtype=torch.float32, pin_memory=True)
                     for _ in range(2)]
        self.turn = 0


class PendingStage:
    """A dispatched stage's `packed` on its way to the host."""

    __slots__ = ("out", "done", "host_s")

    def __init__(self, out: torch.Tensor, done: torch.cuda.Event, host_s: Dict[str, float]):
        self.out, self.done, self.host_s = out, done, host_s

    def numpy(self) -> np.ndarray:
        """(T, n_it, 9) packed estimates, once the stage has run."""
        t0 = time.perf_counter()
        self.done.synchronize()
        packed = self.out.numpy().copy()
        self.host_s["fetch"] += time.perf_counter() - t0
        return packed


class StageGraphs:
    """The stage-graph runner of one tracker on one field, read through
    `frame` (ops/slab.SlabFrame) when the field is a shard's slab (see the
    module docstring): optionally `warm` on a thread first; then per wave
    `load` each slot's carry, `stage` each stage and `finish`."""

    def __init__(self, tracker, field: torch.Tensor, frame=None):
        # the tracker owns its runners: a strong reference back would keep
        # both, and the graphs' device memory, alive until a cyclic GC
        self.tracker = weakref.proxy(tracker)
        self.frame = frame
        self.stream = torch.cuda.Stream(field.device)
        self._field = weakref.ref(field)
        field.record_stream(self.stream)
        self.plan = StagePlan()
        self.slots: Dict[Tuple[int, int], _Slot] = {}
        self.graphs: Dict[Key, _Graph] = {}
        #: stages on the tracing thread, by route
        self.routes = {CAPTURE: 0, REPLAY: 0}
        #: graphs captured by the warm thread, and its `trace_init` calls
        #: (each launches the tracer's kernel twice, counted)
        self.warm_captures = 0
        self.warm_inits = 0
        #: the warm thread's seconds, how long the tracing thread waited
        #: for it in `join_warm`, and the seconds of every capture (its
        #: preparation and the graph's instantiation included)
        self.warm_s = 0.0
        self.warm_wait_s = 0.0
        self.capture_s = 0.0
        #: the caching allocator's reserved bytes added while capturing
        #: (other threads' allocations meanwhile included)
        self.reserved_bytes = 0
        #: the tracing thread's host seconds in its stages (module docstring)
        self.host_s = dict.fromkeys(("staging", "replay", "fetch"), 0.0)
        self.warm_started = False
        self._warm_thread: Optional[threading.Thread] = None
        self._warm_error: Optional[BaseException] = None

    def stats(self) -> dict:
        """The runner's routes, warm captures and `trace_init` calls, warm
        seconds, graphs and their memory, and the tracing thread's host
        seconds in its stages."""
        return {"routes": dict(self.routes), "warm_captures": self.warm_captures,
                "warm_inits": self.warm_inits,
                "warm_s": self.warm_s, "warm_wait_s": self.warm_wait_s,
                "capture_s": self.capture_s,
                "graphs": len(self.plan.seen), "reserved_bytes": self.reserved_bytes,
                "host_s": dict(self.host_s)}

    # -- the warm thread ----------------------------------------------------
    def start_warm(self, ready: torch.cuda.Event, slots: int) -> threading.Thread:
        """Run `warm` on a thread, keeping its exception and its seconds;
        `ready` is recorded behind the field's last write."""
        th = threading.Thread(target=self._warm_main, args=(ready, slots), daemon=True,
                              name="pnr-warm-graphs")
        self.warm_started = True
        self._warm_thread = th
        th.start()
        return th

    def _warm_main(self, ready, slots: int) -> None:
        t0 = time.perf_counter()
        try:
            self.warm(ready, slots)
        except BaseException as e:  # raised again by join_warm
            self._warm_error = e
        finally:
            self.warm_s = time.perf_counter() - t0

    def warm(self, ready: torch.cuda.Event, slots: int) -> None:
        """Capture the graphs of `slots` chunk slots at TRACE_CHUNK traces
        ahead of the first wave (JAX's `warm_async`), on the runner's
        stream after `ready`: `trace_init` on JAX's dummy seeds (positions
        ones, directions (1, 0, 0), keys fold_in(key(0), i)), its carry
        loaded into each slot, each slot's key captured."""
        from pnr_tpu_torch.hostpath import threefry as tf
        from pnr_tpu_torch.ops.threefry import key_tensor
        from pnr_tpu_torch.smc.tracker import trace_keys

        tr = self.tracker
        t = tr.TRACE_CHUNK
        field = self._field()
        with torch.cuda.device(field.device), torch.cuda.stream(self.stream):
            self.stream.wait_event(ready)
            sp = np.ones((t, 3), np.float32)
            sd = np.tile(np.float32([[1.0, 0.0, 0.0]]), (t, 1))
            keys = key_tensor(trace_keys(tf.key_from_seed(0), np.arange(t)), field.device)
            carry, _ = tr.trace_init(field, sp, sd, keys)
            self.warm_inits += 1
            for slot in range(slots):
                self.load(slot, carry, keys)
                key = self._key(slot, t)
                if self.plan.route(key) == CAPTURE:
                    with tr.capture_gate.capture():
                        self.graphs[key] = self._capture(key, field, self.slots[(slot, t)])
                    self.warm_captures += 1
                    _count_warm_capture()

    def join_warm(self) -> None:
        """Wait for the warm thread, if one ran, and raise its exception."""
        th, self._warm_thread = self._warm_thread, None
        if th is not None:
            t0 = time.perf_counter()
            th.join()
            self.warm_wait_s = time.perf_counter() - t0
        err, self._warm_error = self._warm_error, None
        if err is not None:
            raise RuntimeError(f"warming the tracer's stage graphs failed: {err}") from err

    # -- the wave ---------------------------------------------------------
    def _key(self, slot: int, t: int) -> Key:
        return (slot, t, self.tracker.STAGE_ITERS)

    def load(self, slot: int, carry, keys: torch.Tensor) -> None:
        """Copy `trace_init`'s carry of chunk `slot` and the chunk's keys
        (T, 2) int32 on the device into the slot's buffers (once a wave)."""
        key = (slot, int(carry[0].shape[0]))
        s = self.slots.get(key)
        if s is None:
            s = self.slots[key] = _Slot(carry, self.tracker.STAGE_ITERS)
        self.stream.wait_stream(torch.cuda.current_stream(self.stream.device))
        with torch.cuda.stream(self.stream):
            for dst, src in zip(s.carry + (s.keys,), carry + (keys,)):
                dst.copy_(src)
        for src in carry + (keys,):
            src.record_stream(self.stream)

    def finish(self) -> None:
        """Order the caller's stream after every stage dispatched so far."""
        torch.cuda.current_stream(self.stream.device).wait_stream(self.stream)

    def buffers(self, slot: int, t: int):
        """The static device buffers of chunk `slot` at T = t traces (loaded
        once): (carry, keys). Every stage reads and updates them in place;
        write them only inside `writing`."""
        s = self.slots[(slot, t)]
        return s.carry, s.keys

    @contextlib.contextmanager
    def writing(self):
        """Read or write the slots' buffers on the caller's stream between
        stages: after every stage dispatched so far, and before the next."""
        self.finish()
        try:
            yield
        finally:
            self.stream.wait_stream(torch.cuda.current_stream(self.stream.device))

    def stage(self, slot: int, it0: int, kill: np.ndarray) -> PendingStage:
        """Iterations it0 .. it0+STAGE_ITERS-1 of chunk `slot` (its carry
        and keys `load`ed this wave) with the kill mask `kill` (T,) bool:
        captured and replayed, or replayed, as `plan` routes its key."""
        t0 = time.perf_counter()
        field = self._field()
        t = len(kill)
        s = self.slots[(slot, t)]
        key = self._key(slot, t)
        route = self.plan.route(key)
        self.routes[route] += 1
        st = s.staging[s.turn]
        out = s.outs[s.turn]
        s.turn ^= 1
        st.copied.synchronize()  # the copies that last read this set have run
        st.kill_np[:] = kill
        st.it0_np[()] = it0
        with torch.cuda.stream(self.stream):
            s.kill.copy_(st.kill, non_blocking=True)
            s.it0.copy_(st.it0, non_blocking=True)
            st.copied.record()
            tc = time.perf_counter()
            if route == CAPTURE:  # its seconds go to `capture_s`
                self.graphs[key] = self._capture(key, field, s)
            t1 = time.perf_counter()
            packed = self._replay(key)
            t2 = time.perf_counter()
            out.copy_(packed, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        self.host_s["replay"] += t2 - t1
        self.host_s["staging"] += time.perf_counter() - t2 + tc - t0
        return PendingStage(out, done, self.host_s)

    def close(self) -> None:
        """Drop the graphs once nothing replays into their memory; then
        raise the warm thread's exception if no wave has."""
        try:
            self.join_warm()
        finally:
            self.stream.synchronize()
            self.graphs.clear()
            self.slots.clear()

    def _run(self, field, s: _Slot) -> torch.Tensor:
        carry, packed = self.tracker._stage_body(field, s.carry, s.keys, s.it0, s.kill, s.iters,
                                                 self.frame)
        for dst, src in zip(s.carry, carry):
            dst.copy_(src)
        return packed

    def _capture(self, key: Key, field, s: _Slot) -> _Graph:
        t0 = time.perf_counter()
        # on this thread and stream: the lazy state no capture may create
        self.tracker.prepare_graphs(field, self.stream, key[1], self.frame)
        graph = torch.cuda.CUDAGraph()
        launches: Dict[Counter, int] = {}
        before = torch.cuda.memory_reserved(self.stream.device)
        _TALLY.counts = launches
        try:
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                packed = self._run(field, s)
            finally:
                graph.capture_end()
        except RuntimeError as e:
            raise RuntimeError(f"capturing the tracer stage (slot, T, n_it) = {key} failed: "
                               f"{e}") from e
        finally:
            _TALLY.counts = None
        _take_back(launches)
        self.reserved_bytes += torch.cuda.memory_reserved(self.stream.device) - before
        self.capture_s += time.perf_counter() - t0
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
