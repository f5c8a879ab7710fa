"""Where one stack's time goes, measured inside the program.

Two kinds of interval, both always on:

* Stages (`StageTimer`): the pipeline's stages, one after another on one
  thread. On a card `stop` synchronises the thread's current streams
  first, so a stage's seconds are its device time. A stack's stages are
  `ReconstructionResult.timings`, and nothing else enters them.
* Part spans (`span`): the parts of a stage where the work happens, on
  whichever thread runs them: the tracing thread, a prefetch worker of
  `reconstruction_batch` or a stage-graph warm thread. A span does not
  synchronise: it is the host thread's interval. Each records its name,
  its parent (the innermost stage or span open on its thread, None at the
  top of a thread), the thread and its start and end
  (`time.perf_counter_ns`).

A stack's spans go to its `Spans`, bound to each thread while that
thread works for the stack (`bound`; a prefetch worker and a warm thread
run bound to the stack they start for, `call_bound`), so they share its
identifier whichever thread ran them. A span with no stack bound is timed
for its `into` and its profiler range only. A finished stack's span totals
are `ReconstructionResult.spans`, and `Spans.finish` keeps its timings
beside them in a bounded log of the process's last RECENT stacks (`recent`), which a
reader in the same process (the benchmark's per-layer metrics) finds by
the timings.

Spans sit at stage granularity: never inside a per-trace, per-node or
per-seed loop. NAMES lists every span and what it times.

While a torch profiler session records, each stage and span is also a
profiler range of its name, on the profiler's clock:
`_RecordFunctionFast`, a host event that leaves no device-side annotation
(a `record_function` range leaves a `gpu_user_annotation` spanning it,
which a trace reader counts as device work). A session records the
threads its configuration covers: by default only the thread that started
it. No name starts with "cu" or "bench: ", the prefixes by which the
benchmark's trace reader names the card's idle gaps.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler

#: every part span, by name: what it times (the module docstring)
NAMES = {
    "seeds.fetch": "J8 copied to the host (`j8.cpu().numpy()`, pageable)",
    "seeds.flood": "the seed flood (`seed_mask`) and its mask's voxel list",
    "seeds.directions": "the directions gathered at the seeds on the device",
    "tracing.select": "a wave's seeds chosen past the suppression check",
    "tracing.init": "a wave's `trace_init`, its carry loaded into the stage graphs, est0 fetched",
    "tracing.warm_wait": "the tracing thread waiting for the warm thread (`join_warm`)",
    "tracing.dispatch": "one chunk's stage dispatched: staging, capture and replay, or eager launches",
    "tracing.capture": "one stage graph captured, under dispatch or warm.capture",
    "tracing.replay": "one stage graph's replay call, under dispatch",
    "tracing.wait": "one chunk's stage estimates fetched, waiting for the card",
    "tracing.commit": "the commit wavefront advanced between stages (`advance_commits`)",
    "tracing.checkpoint": "the trace state written (`save_checkpoint`)",
    "graph.resample": "the raw nodes resampled along their links",
    "graph.refine": "mean shift (`non_blurring`), its upload and fetch included",
    "graph.group": "the refined nodes grouped (`group1`)",
    "graph.forest": "the BFS forest of the grouped nodes",
    "graph.trees": "tree extraction and tail pruning",
    "graph.interpolate": "the trees interpolated at one voxel",
    "serve.front_wait": "`reconstruction_batch` waiting for a prefetched front",
    "serve.hand_over": "the front handed to the tracing stream (`_hand_over`)",
    "warm.init": "the warm thread's `trace_init` on dummy seeds",
    "warm.capture": "the warm thread loading one slot and capturing its graph (a closed gate's "
                    "wait included)",
}

#: stacks the process-wide log keeps
RECENT = 256

#: the profiler range kind (None where this torch has none)
_RANGE = getattr(torch._C._profiler, "_RecordFunctionFast", None)

_now = time.perf_counter_ns
_thread = threading.get_ident
_STACK_IDS = itertools.count(1)
_LOG: "collections.deque[dict]" = collections.deque(maxlen=RECENT)
_LOG_LOCK = threading.Lock()

Record = Tuple[str, Optional[str], int, int, int]  # name, parent, thread, start ns, end ns


class _Thread(threading.local):
    spans: Optional["Spans"] = None  # the stack this thread works for
    open: Optional[str] = None  # the innermost open stage or span


_LOCAL = _Thread()


def _open_range(name: str):
    """A profiler range of `name`, entered, while a session records (a
    module flag torch sets at a session's start and clears at its stop);
    else None."""
    if not _autograd_profiler._is_profiler_enabled or _RANGE is None:
        return None
    rng = _RANGE(name)
    rng.__enter__()
    return rng


class Spans:
    """The part spans of one stack, from every thread that worked for it."""

    __slots__ = ("stack", "records")

    def __init__(self):
        self.stack = next(_STACK_IDS)
        self.records: List[Record] = []  # appended to by its threads (an atomic append)

    def totals(self) -> Dict[str, Tuple[float, int]]:
        """Seconds and count of each span name."""
        out: Dict[str, Tuple[float, int]] = {}
        for name, _, _, t0, t1 in list(self.records):
            s, n = out.get(name, (0.0, 0))
            out[name] = (s + (t1 - t0) / 1e9, n + 1)
        return out

    def finish(self, timings: Dict[str, float]) -> Dict[str, Tuple[float, int]]:
        """The finished stack's totals, logged beside its stage `timings`."""
        totals = self.totals()
        with _LOG_LOCK:
            _LOG.append({"stack": self.stack, "timings": dict(timings), "spans": dict(totals)})
        return totals


def current() -> Optional[Spans]:
    """The stack the calling thread works for, if one is bound."""
    return _LOCAL.spans


@contextlib.contextmanager
def bound(spans: Optional[Spans]):
    """Bind the calling thread to `spans` (a stack) for the block."""
    loc = _LOCAL
    prev = loc.spans, loc.open
    loc.spans, loc.open = spans, None
    try:
        yield spans
    finally:
        loc.spans, loc.open = prev


def call_bound(stack: Optional[Spans], fn, *args):
    """`fn(*args)` with the calling thread bound to `stack`: the target of
    a thread that works for the stack."""
    with bound(stack):
        return fn(*args)


class span:
    """A part span of `name` (one of NAMES) around a block, recorded on the
    bound stack; its seconds are also added to `into[name]` when `into`
    (a dict) is given."""

    __slots__ = ("name", "into", "_parent", "_range", "_t0")

    def __init__(self, name: str, into: Optional[Dict[str, float]] = None):
        self.name, self.into = name, into

    def __enter__(self):
        loc = _LOCAL
        self._parent, loc.open = loc.open, self.name
        self._range = _open_range(self.name) if _autograd_profiler._is_profiler_enabled else None
        self._t0 = _now()
        return self

    def __exit__(self, *exc):
        t1 = _now()
        if self._range is not None:
            self._range.__exit__(None, None, None)
        loc = _LOCAL
        loc.open = self._parent
        stack = loc.spans
        if stack is not None:
            stack.records.append((self.name, self._parent, _thread(), self._t0, t1))
        if self.into is not None:
            self.into[self.name] = self.into.get(self.name, 0.0) + (t1 - self._t0) / 1e9
        return False


class StageTimer:
    """Per-stage wall clock. On a CUDA device `stop` synchronises the
    calling thread's current stream first, so a stage's time is its device
    time, not its dispatch time; a prefetch worker's stages and the main
    thread's tracing, each on its own stream, do not wait for each other.
    `device` may be a sequence of devices (a mesh's): `stop` then
    synchronises the current stream of each card among them. A running
    stage is the parent of the part spans its thread opens."""

    def __init__(self, verbose: bool, device):
        self.timings: Dict[str, float] = {}
        self.verbose = verbose
        devices = device if isinstance(device, (list, tuple)) else (device,)
        self.devices = tuple(d for d in dict.fromkeys(devices) if d.type == "cuda")
        self._t0 = None
        self._name = None
        self._parent = None
        self._range = None

    def start(self, name: str):
        if self.verbose:
            print(f"{name}... ", end="", flush=True)
        loc = _LOCAL
        self._parent, loc.open = loc.open, name
        self._range = _open_range(name)
        self._name, self._t0 = name, time.perf_counter()

    def stop(self):
        for d in self.devices:
            torch.cuda.current_stream(d).synchronize()
        dt = time.perf_counter() - self._t0
        self.timings[self._name] = self.timings.get(self._name, 0.0) + dt
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        _LOCAL.open = self._parent
        if self.verbose:
            print(f"{dt:.3f} sec.")

    def lap(self, name: str):
        """Stop the running stage and start `name`."""
        self.stop()
        self.start(name)


def recent() -> List[dict]:
    """The logged stacks, oldest first: {"stack", "timings", "spans"} each."""
    with _LOG_LOCK:
        return list(_LOG)
