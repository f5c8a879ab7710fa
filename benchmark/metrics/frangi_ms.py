"""frangi_ms: the filter's seconds a stack (`timings["frangi"]`, K1 on the
card), summed over the window's stacks before the trace over their count,
in ms."""


def read(rec):
    return rec.stage_ms("frangi")
