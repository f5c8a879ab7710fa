"""front_overlap: every stage second of the window's stacks before the
trace over their seconds. Above 1, stages ran side by side: the prefetched fronts
hid behind tracing."""


def read(rec):
    if not rec.stacks:
        return None
    return sum(sum(s["timings"].values()) for s in rec.stacks) / rec.window_s
