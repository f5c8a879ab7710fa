"""front_wait_ms: `reconstruction_batch` waiting for a prefetched front a
stack (the program's span `serve.front_wait`: `fut.result()`), over the
stacks the stage metrics read, in ms."""

from benchmark.metrics._program_spans import span_ms


def read(rec):
    return span_ms(rec, "serve.front_wait")
