"""k1_roofline: K1's bound over its device time in the traced window, %.

The bound of one stack's filter is the larger of its bytes (the uint8
stack in once, J and three direction volumes out once) over the memory
rate and its FLOPs (`frangi_flops`) over the float32 rate; the stacks
counted are the filter passes the trace holds (one `frangi_fused_kernel`
launch a sigma)."""

from benchmark.core import roofline


def read(rec):
    if rec.trace is None:
        return None
    dev_s, _ = rec.trace.kernel_s("frangi_fused_kernel", "decode_stats_kernel")
    _, passes = rec.trace.kernel_s("frangi_fused_kernel")
    stacks = passes / len(rec.cfg.sigmas)
    if dev_s <= 0 or stacks <= 0:
        return None
    n = rec.voxels
    bound = roofline.bound_s(roofline.frangi_bytes(n),
                             roofline.frangi_flops(n, rec.cfg.sigmas, rec.cfg.zdist))
    return 100.0 * stacks * bound / dev_s
