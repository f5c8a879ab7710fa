"""The per-layer metrics read from the program's part spans: a traced run
of each loop's small cell on the CPU reads each of them as a finite
number of at least 0, over the stacks the stage metrics read; the batch
cell alone reads the wait for a front; a program whose log misses the
stacks gives nothing."""

import math

import pytest

from benchmark import run
from benchmark.tests._small import CONFIG, SEED, TRAFFIC

SPAN_METRICS = ("seeds_fetch_ms", "seeds_flood_ms", "tracing_dispatch_ms", "tracing_wait_ms",
                "tracing_commit_ms", "graph_refine_ms")


def _traced(workload):
    traffic = dict(TRAFFIC)
    if "batch" in workload:
        traffic["warmup_stacks"] = 2
    return run.run_cell(workload, SEED, 0.5, True, device="cpu", traffic_override=traffic,
                        config_override=CONFIG, check_stacks=1, log=lambda *a, **k: None)


@pytest.mark.parametrize("workload,extra", [("exact-arbors-single", ()),
                                            ("exact-arbors-batch", ("front_wait_ms",))])
def test_a_traced_run_reads_the_span_metrics(workload, extra):
    out = _traced(workload)
    got = {k: v["value"] for k, v in out["metrics"].items()
           if k in SPAN_METRICS + ("front_wait_ms",)}
    assert set(got) == set(SPAN_METRICS + extra)
    assert all(math.isfinite(v) and v >= 0 for v in got.values()), got
    assert all(out["metrics"][k]["unit"] == "ms" for k in got)
    # on the same stacks the parts lie inside their stages
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert m["seeds_fetch_ms"] + m["seeds_flood_ms"] <= m["seeds_ms"]
    assert m["tracing_dispatch_ms"] + m["tracing_wait_ms"] + m["tracing_commit_ms"] \
        <= m["tracing_ms"]
    assert m["graph_refine_ms"] <= m["graph_ms"]


def test_stacks_missing_from_the_log_give_nothing(monkeypatch):
    from benchmark.metrics import _program_spans
    from pnr_tpu_torch.utils import spans

    rec = run.Record(None, None, None, [{"timings": {"frangi": 0.25}}], 1.0, [], {}, None, (1,))
    monkeypatch.setattr(spans, "recent", lambda: [])
    assert _program_spans.span_ms(rec, "seeds.fetch") is None
    monkeypatch.setattr(spans, "recent", lambda: [{"timings": {"frangi": 0.25},
                                                   "spans": {"seeds.fetch": (0.002, 1)}}])
    assert _program_spans.span_ms(rec, "seeds.fetch") == pytest.approx(2.0)
    assert _program_spans.span_ms(rec, "serve.front_wait") == 0.0
