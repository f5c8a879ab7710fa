"""The port's part spans (utils/spans.py) on the CPU: they nest in their
stages and in each other, the spans of a prefetch worker and of a warm
thread land on their own stack, the stage timings keep their keys, the
log of recent stacks is bounded, each span is a host event of its name
while a profiler session records and no range at all while none does,
and the CLI's metrics record carries them."""

import ast
import dataclasses
import os
import threading
import time
import types

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from _torch_once import once
from pnr_tpu_torch.config import PNRConfig
from pnr_tpu_torch.pipeline import reconstruct, reconstruction_batch, reconstruction_func
from pnr_tpu_torch.smc import graphs
from pnr_tpu_torch.utils import spans
from pnr_tpu_torch.utils.exporters import metrics_entry

PKG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "pnr_tpu_torch")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the suite's xdist workers share the host's cores
    with each other and with XLA's threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CFG = PNRConfig(
    sigmas=(2.0,), somaradius=0, tolerance=10.0, znccth=0.5, kappa=2.0,
    step=2, ni=12, np=8, zdist=2.0, nodepervol=4, vol=9, wave_size=8,
    zncc_mode="tube",
)
STAGES = {"frangi", "seed extraction", "seed selection & sorting", "tracing", "reconstruct"}


def tube_stack(seed=0, shape=(8, 32, 64)):
    """A modulated x-aligned tube with noise."""
    rng = np.random.default_rng(seed)
    z, y, x = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    d2 = (y - shape[1] // 2) ** 2 + ((z - shape[0] // 2) * 2.0) ** 2
    vol = 200.0 * np.exp(-d2 / (2 * 2.5**2)) * (0.7 + 0.3 * np.sin(x / 4.0))
    return np.clip(vol + rng.normal(0, 5, shape), 0, 255).astype(np.uint8)


def traced_stack(cfg=CFG, vol=None):
    """One stack through `reconstruction_func` with its spans' records
    kept: (result, the stack's Spans)."""
    stack = spans.Spans()
    vol = tube_stack() if vol is None else vol
    with spans.bound(stack):
        front = reconstruct._stack_front(vol, cfg, torch.device("cpu"), verbose=False)
    return reconstruction_func(vol, cfg, verbose=False, _front=front, device="cpu"), stack


@pytest.fixture(scope="module")
def one(tmp_path_factory):
    return once(tmp_path_factory, "spans_one", traced_stack)


def test_the_stack_spans_every_stage_and_its_parts(one):
    res, stack = one
    assert set(res.timings) == STAGES
    want = {"seeds.fetch", "seeds.flood", "seeds.directions", "tracing.select", "tracing.init",
            "tracing.dispatch", "tracing.wait", "tracing.commit", "graph.resample", "graph.refine",
            "graph.group", "graph.forest", "graph.trees", "graph.interpolate"}
    assert set(res.spans) == want and res.spans == stack.totals()
    assert res.trace_count > 0
    for name, (s, n) in res.spans.items():
        assert s >= 0 and n >= 1, name
    assert all(res.spans[k][1] == 1 for k in ("seeds.fetch", "seeds.flood", "graph.refine"))
    # a stage's parts lie inside it: their seconds are at most its own
    for stage, prefix in (("seed extraction", "seeds."), ("reconstruct", "graph.")):
        assert sum(s for k, (s, _) in res.spans.items() if k.startswith(prefix)) \
            <= res.timings[stage]
    assert sum(res.spans[k][0] for k in ("tracing.dispatch", "tracing.wait", "tracing.commit")) \
        <= res.timings["tracing"]


def test_parents_nest(one):
    """Each span's parent is the stage its thread ran, or a span of the same
    thread whose interval holds it."""
    _, stack = one
    recs = stack.records
    for name, parent, thread, t0, t1 in recs:
        assert t0 <= t1 and parent is not None, name
        if parent in STAGES:
            assert name.split(".")[0] == {"seed extraction": "seeds", "tracing": "tracing",
                                          "reconstruct": "graph"}[parent], (name, parent)
            continue
        assert any(n == parent and th == thread and a <= t0 and t1 <= b
                   for n, _, th, a, b in recs), (name, parent)
    nested = spans.Spans()
    with spans.bound(nested):
        with spans.span("tracing.dispatch"):
            with spans.span("tracing.capture"):
                pass
        with spans.span("tracing.wait"):
            pass
    assert [(n, p) for n, p, *_ in nested.records] == [
        ("tracing.capture", "tracing.dispatch"), ("tracing.dispatch", None), ("tracing.wait", None)]


def test_the_spans_leave_the_timings_alone(one):
    """`timings` holds the stages only: spans neither add keys nor enter
    `front_overlap`'s sum; a span with no stack bound records nowhere and
    still adds to its `into`."""
    res, _ = one
    assert set(res.timings) == STAGES
    into = {}
    assert spans.current() is None
    with spans.span("tracing.wait", into=into):
        time.sleep(0.002)
    with spans.span("tracing.wait", into=into):
        pass
    assert into["tracing.wait"] >= 0.002 and list(into) == ["tracing.wait"]


def test_a_prefetch_workers_spans_land_on_their_own_stack(monkeypatch):
    """With prefetch, each front runs on a worker thread: its seed spans,
    the batch loop's wait for it and the tracing thread's spans all land on
    its own stack, and on no other."""
    made = []
    real = reconstruct._stack_front

    def front(*a, **k):
        made.append(spans.current())
        return real(*a, **k)

    monkeypatch.setattr(reconstruct, "_stack_front", front)
    cfg = dataclasses.replace(CFG, ni=8)
    vols = [tube_stack(i) for i in range(3)]
    main = threading.get_ident()
    out = list(reconstruction_batch(vols, cfg, verbose=False, prefetch=True, prefetch_depth=2,
                                    device="cpu"))
    assert len(made) == 3 and len({id(s) for s in made}) == 3
    for res in out:
        # the workers run side by side: a result finds its stack by its spans
        (stack,) = [s for s in made if s.totals() == res.spans]
        assert {k: n for k, (_, n) in res.spans.items() if k.startswith(("seeds.", "serve."))} \
            == {"seeds.fetch": 1, "seeds.flood": 1, "seeds.directions": 1,
                "serve.front_wait": 1, "serve.hand_over": 1}
        where = {name: thread for name, _, thread, _, _ in stack.records}
        assert where["seeds.fetch"] != main and where["serve.front_wait"] == main
        assert where["graph.refine"] == main


class WarmRunner:
    """`StageGraphs`' warm thread and its join, whose warm work is two
    spans."""

    start_warm = graphs.StageGraphs.start_warm
    _warm_main = graphs.StageGraphs._warm_main
    join_warm = graphs.StageGraphs.join_warm
    warm_s = graphs.StageGraphs.warm_s
    warm_wait_s = graphs.StageGraphs.warm_wait_s

    def __init__(self):
        self.warm_started, self._warm_thread, self._warm_error = False, None, None
        self.spent, self.warm_spent = {}, {}
        self.go = threading.Event()

    def warm(self, ready, slots):
        with spans.span("warm.init", into=self.warm_spent):
            self.go.wait(10)
        for _ in range(slots):
            with spans.span("warm.capture", into=self.warm_spent):
                pass


def test_the_warm_threads_spans_land_on_their_stack():
    """The warm thread takes the stack of the thread that started it; a
    stack bound meanwhile on the starting thread, and another thread's
    stack, get none of its spans. `stats()`'s warm seconds are read from
    the spans."""
    a, b = spans.Spans(), spans.Spans()
    runner = WarmRunner()
    with spans.bound(a):
        th = runner.start_warm(None, 2)
    with spans.bound(b):
        with spans.span("tracing.select"):
            runner.go.set()
    with spans.bound(a):
        runner.join_warm()
    assert not th.is_alive()
    assert [(n, p) for n, p, *_ in a.records] == [
        ("warm.init", None), ("warm.capture", None), ("warm.capture", None),
        ("tracing.warm_wait", None)]
    assert [t for _, _, t, _, _ in a.records] == [th.ident] * 3 + [threading.get_ident()]
    assert [n for n, *_ in b.records] == ["tracing.select"]
    tot = a.totals()
    assert runner.warm_s == pytest.approx(tot["warm.init"][0] + tot["warm.capture"][0])
    assert runner.warm_wait_s == tot["tracing.warm_wait"][0]


def test_the_log_is_bounded():
    made = []
    for i in range(spans.RECENT + 5):
        made.append(spans.Spans())
        with spans.bound(made[-1]):
            with spans.span("seeds.fetch"):
                pass
        assert made[-1].finish({"frangi": float(i)}) == made[-1].totals()
    log = spans.recent()
    assert len(log) == spans.RECENT
    assert log[0]["timings"] == {"frangi": 5.0} and log[0]["stack"] == made[5].stack
    assert log[-1] == {"stack": made[-1].stack, "timings": {"frangi": float(spans.RECENT + 4)},
                       "spans": made[-1].totals()}


def test_a_finished_stack_is_logged_by_its_timings():
    res = reconstruction_func(tube_stack(3), dataclasses.replace(CFG, ni=4), verbose=False,
                              device="cpu")
    hit = [e for e in spans.recent() if e["timings"] == res.timings]
    assert len(hit) == 1 and hit[0]["spans"] == res.spans


def test_each_span_is_a_host_event_while_a_profiler_records(monkeypatch):
    """Under a CPU profiler session every span of the stack is a host event
    of its name, once per span, and so is every stage; with none
    recording no range is made."""
    opened = []
    real = spans._RANGE

    def counting(name):
        opened.append(name)
        return real(name)

    monkeypatch.setattr(spans, "_RANGE", counting)
    cfg = dataclasses.replace(CFG, ni=4)
    res, _ = traced_stack(cfg)
    assert res.spans and opened == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res, _ = traced_stack(cfg, tube_stack(1))
    seen = {}
    for e in prof.profiler.kineto_results.events():
        assert e.device_type() == DeviceType.CPU
        seen[e.name()] = seen.get(e.name(), 0) + 1
    for name, (_, n) in res.spans.items():
        assert seen.get(name) == n, name
    assert all(seen.get(stage) == 1 for stage in STAGES)
    assert len(opened) == sum(n for _, n in res.spans.values()) + len(STAGES)


def _span_names():
    """The names the package's code passes to `span(...)`."""
    for d, _, files in os.walk(PKG):
        for f in files:
            if not f.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(d, f)).read())
            for node in ast.walk(tree):
                if isinstance(node, ast.Call) and getattr(node.func, "id", getattr(
                        node.func, "attr", None)) == "span" and node.args:
                    yield node.args[0].value


def test_every_span_is_named_in_names_and_not_by_a_readers_prefix():
    used = set(_span_names())
    assert used == set(spans.NAMES)
    assert not [n for n in used if n.startswith(("cu", "bench: "))]


def test_metrics_entry_carries_the_spans(one):
    res, _ = one
    entry = metrics_entry("x.tif", res)
    assert list(entry)[:3] == ["image", "timings_s", "spans"]
    assert entry["spans"] == {k: {"s": round(s, 6), "n": n} for k, (s, n) in res.spans.items()}
    host = types.SimpleNamespace(timings={"frangi": 0.1}, seeds_pos=np.zeros((0, 3)),
                                 trace_count=0, n0=[None], tree=[None])
    assert metrics_entry("y.tif", host)["spans"] == {}
