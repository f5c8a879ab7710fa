"""tracing_commit_ms: the commit wavefront on the host a stack (the
program's span `tracing.commit`: `advance_commits` between stages), over
the stacks the stage metrics read, in ms."""

from benchmark.metrics._program_spans import span_ms


def read(rec):
    return span_ms(rec, "tracing.commit")
