"""graph_ms: the graph stage's seconds a stack (`timings["reconstruct"]`:
resampling, refinement, grouping, trees), in ms."""


def read(rec):
    return rec.stage_ms("reconstruct")
