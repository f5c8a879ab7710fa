"""seeds_fetch_ms: J8 copied to the host a stack (the program's span
`seeds.fetch`: `j8.cpu().numpy()` into pageable memory), over the stacks
the stage metrics read, in ms."""

from benchmark.metrics._program_spans import span_ms


def read(rec):
    return span_ms(rec, "seeds.fetch")
