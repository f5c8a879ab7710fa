"""tracing_wait_ms: the tracing thread waiting for stages' estimates a
stack (the program's span `tracing.wait`: each stage's fetch, which waits
for the card), over the stacks the stage metrics read, in ms."""

from benchmark.metrics._program_spans import span_ms


def read(rec):
    return span_ms(rec, "tracing.wait")
