"""k2_roofline: K2's bound over its device time in the traced span, %.

The work is what the span's stacks needed, not the lanes K2 ran: each
raw node the tracer committed and each trace's stopping iteration is one
iteration of np particle queries and one centroid query, each raw seed one
scoring query; a query samples the whole template lattice of every sigma
at K2_SAMPLE_FLOPS. Bytes: each stack read once. Dead lanes and the
iterations a suppressed trace ran on are left out, so the share is a floor.
The span opens and closes at completions: in a single loop it holds all
of its stacks' launches and no other. In a prefetched batch it also holds
the seed scoring of the fronts that run ahead (one launch of ~700 queries
a stack against ~460,000 of its tracing) in place of its first stacks'
own, and the warm thread's two trace_init launches a stack: the work
counted and the work run then differ by well under 1%."""

from benchmark.core import roofline


def read(rec):
    if rec.trace is None or not rec.traced_stacks:
        return None
    dev_s, _ = rec.trace.kernel_s("exact_sums_kernel")
    if dev_s <= 0:
        return None
    npart = rec.cfg.np
    queries = sum((s["n0"] + s["traces"]) * (npart + 1) + s["n_raw_seeds"] for s in rec.traced_stacks)
    flops = queries * roofline.template_samples(rec.cfg.sigmas) * roofline.K2_SAMPLE_FLOPS
    return 100.0 * roofline.bound_s(len(rec.traced_stacks) * rec.voxels, flops) / dev_s
