"""scoring_ms: the field and seed scoring's seconds a stack
(`timings["seed selection & sorting"]`: in tube mode the map build and
tube_corr scoring, in exact mode K2 scoring), in ms."""


def read(rec):
    return rec.stage_ms("seed selection & sorting")
