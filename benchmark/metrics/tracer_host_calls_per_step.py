"""tracer_host_calls_per_step: the host's kernel and graph launch calls in
the traced span over the tracer's steps there (a step is one iteration
of one chunk: two K2 or tube_corr launches, counted by the port's launch
counters, graph replays included; exact mode leaves out seed scoring's K2
launches, one per 4,096 raw seeds)."""

import math


def read(rec):
    if rec.trace is None:
        return None
    if rec.cfg.zncc_mode == "tube":
        launches = rec.counts.get("tube_corr_trace", 0)
    else:
        scoring = sum(math.ceil(s["n_raw_seeds"] / 4096) for s in rec.traced_stacks)
        launches = rec.counts.get("k2", 0) - scoring
    steps = launches / 2
    if steps <= 0:
        return None
    return rec.trace.host_launch_calls / steps
