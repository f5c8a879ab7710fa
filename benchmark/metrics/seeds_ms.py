"""seeds_ms: seed extraction's seconds a stack (`timings["seed extraction"]`:
the J8 fetch, the native flood and the direction gather), in ms."""


def read(rec):
    return rec.stage_ms("seed extraction")
