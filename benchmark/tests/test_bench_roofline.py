"""The roofline counts at a tiny size."""

import math

import numpy as np
import pytest

from benchmark.core import roofline
from benchmark.core.profile import Trace
from benchmark.reference.zncc import Exact, Tube


def test_template_and_line_samples_are_the_reference_lattices():
    for sig in ((2.0,), (2.0, 4.0, 6.0), (3.0, 5.0)):
        assert roofline.template_samples(sig) == Exact(sig).samples_per_query()
        assert roofline.line_samples(sig) == Tube(sig).samples_per_query()
    # sigma 2: v in -2..2, u and w in -6..6 at pitch 1
    assert roofline.template_samples((2.0,)) == 5 * 13 * 13


def test_frangi_flops_and_bytes():
    # sigma 2, zdist 2: 13 taps in x and y, 7 in z
    assert roofline.frangi_flops(10, (2.0,), 2.0) == 10 * (2 * (2 * 13 + 7) + 18 + roofline.EIG_FLOPS)
    assert roofline.frangi_bytes(10) == 80


def test_bound_is_the_larger_side():
    assert roofline.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert roofline.bound_s(0, 67e12) == pytest.approx(1.0)
    assert roofline.bound_s(3.35e12, 134e12) == pytest.approx(2.0)


class _Cfg:
    sigmas, zdist, np, zncc_mode = (2.0,), 2.0, 4, "exact"


class _Rec:
    def __init__(self, trace, stacks):
        self.cfg, self.trace, self.voxels = _Cfg(), trace, 1000
        self.stacks = self.traced_stacks = stacks


def test_k2_roofline_counts_what_the_stacks_needed():
    from benchmark.metrics import k2_roofline

    stacks = [{"n0": 100, "traces": 10, "n_raw_seeds": 50}]
    queries = 110 * 5 + 50
    flops = queries * 845 * roofline.K2_SAMPLE_FLOPS
    dev_s = 2 * flops / 67e12
    tr = Trace(1.0, 0.5, [("exact_sums_kernel<3>", 0, int(dev_s * 1e9))], 0, {})
    assert k2_roofline.read(_Rec(tr, stacks)) == pytest.approx(50.0, rel=1e-3)
    empty = Trace(1.0, 0.5, [], 0, {})
    assert k2_roofline.read(_Rec(empty, stacks)) is None


def test_k1_roofline_from_the_passes_seen():
    from benchmark.metrics import k1_roofline

    n = 10**8
    b = roofline.bound_s(roofline.frangi_bytes(n), roofline.frangi_flops(n, (2.0,), 2.0))
    # two stacks' passes (one sigma) taking 4 bounds of device time
    ns = int(2 * b * 1e9)
    tr = Trace(1.0, 0.5, [("frangi_fused_kernel", 0, ns), ("frangi_fused_kernel", ns, 2 * ns)], 0, {})
    rec = _Rec(tr, [{}])
    rec.voxels = n
    assert k1_roofline.read(rec) == pytest.approx(50.0, rel=1e-6)


def test_idle_share():
    from benchmark.metrics import device_idle_share

    tr = Trace(2.0, 0.5, [], 0, {})
    assert device_idle_share.read(_Rec(tr, [])) == pytest.approx(75.0)
    assert math.isfinite(device_idle_share.read(_Rec(tr, [])))
    assert np.isclose(device_idle_share.read(_Rec(Trace(2.0, 2.0, [], 0, {}), [])), 0.0)


def test_stage_timings_from_the_stacks_before_the_trace_device_work_from_the_span():
    """A traced run reads a stage's ms from the stacks the profiler did not
    slow, and K2's work from the stacks whose launches the span holds."""
    from benchmark import run
    from benchmark.metrics import front_overlap, k2_roofline, tracing_ms

    before = [{"timings": {"tracing": 2.0, "reconstruct": 1.0}, "n0": 1, "traces": 1,
               "n_raw_seeds": 1}] * 3
    span = [{"timings": {"tracing": 4.0, "reconstruct": 2.0}, "n0": 100, "traces": 10,
             "n_raw_seeds": 50}]
    queries = 110 * 5 + 50
    dev_s = 2 * queries * 845 * roofline.K2_SAMPLE_FLOPS / 67e12
    tr = Trace(1.0, 0.5, [("exact_sums_kernel<3>", 0, int(dev_s * 1e9))], 0, {})
    rec = run.Record(_Cfg(), {}, {}, before, 9.0, span, {}, tr, (10, 10, 10))
    assert tracing_ms.read(rec) == pytest.approx(2000.0)
    assert front_overlap.read(rec) == pytest.approx(1.0)
    assert k2_roofline.read(rec) == pytest.approx(50.0, rel=1e-3)
