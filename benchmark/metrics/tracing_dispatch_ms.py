"""tracing_dispatch_ms: the tracing thread dispatching stages a stack (the
program's span `tracing.dispatch`: staging, captures and graph replay
calls, or the eager launches), over the stacks the stage metrics read, in
ms."""

from benchmark.metrics._program_spans import span_ms


def read(rec):
    return span_ms(rec, "tracing.dispatch")
