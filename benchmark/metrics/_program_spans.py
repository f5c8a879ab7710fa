"""The program's part spans (`pnr_tpu_torch/utils/spans.py`) of the stacks
the stage metrics read: the program logs each finished stack's stage
timings beside its span totals, and a stack of `rec.stacks` is found in
that log by its timings. A program without the log, or a log that misses
one of the stacks, gives nothing."""


def span_ms(rec, name: str):
    """`name`'s seconds a stack over `rec.stacks`, in ms, or None."""
    if not rec.stacks:
        return None
    try:
        from pnr_tpu_torch.utils import spans
    except ImportError:
        return None
    log = spans.recent()
    total = 0.0
    for stack in rec.stacks:
        entry = next((e for e in reversed(log) if e["timings"] == stack["timings"]), None)
        if entry is None:
            return None
        total += entry["spans"].get(name, (0.0, 0))[0]
    return 1e3 * total / len(rec.stacks)
