"""seeds_flood_ms: the seed flood a stack (the program's span
`seeds.flood`: the native flood on the host and its mask's voxel list),
over the stacks the stage metrics read, in ms."""

from benchmark.metrics._program_spans import span_ms


def read(rec):
    return span_ms(rec, "seeds.flood")
