"""graph_refine_ms: mean shift a stack (the program's span
`graph.refine`: `non_blurring`, its upload and fetch included), over the
stacks the stage metrics read, in ms."""

from benchmark.metrics._program_spans import span_ms


def read(rec):
    return span_ms(rec, "graph.refine")
