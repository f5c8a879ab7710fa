"""tracing_ms: the tracer's seconds a stack (`timings["tracing"]`: the
wave loop, its stage graphs and commits), in ms."""


def read(rec):
    return rec.stage_ms("tracing")
