"""Device-mesh parallelism: halo exchange, the sharded filter, boundary
handoff of traces, the per-card memory planner, batches over a mesh (one
stack a device, and groups of devices a stack) and the multi-process
runtime on torch.distributed."""

from pnr_tpu_torch.parallel.halo import halo_exchange_z, halo_exchange_z_aligned
from pnr_tpu_torch.parallel.handoff import (
    build_handoff_trace_step,
    build_handoff_tracer,
    required_trace_halo,
    stitch_estimates,
)
from pnr_tpu_torch.parallel.multihost import (
    allgather_host_rows,
    fetch_replicated,
    init_multihost,
    make_global_mesh,
    shard_volume_global,
    shutdown_multihost,
)
from pnr_tpu_torch.parallel.plan import ShardPlan, card_memory_bytes, min_devices, plan_sharded
from pnr_tpu_torch.parallel.sharded import (
    Mesh,
    assign_seeds_to_shards,
    build_local_trace_step,
    build_sharded_step,
    frangi2d_halo,
    frangi2d_sharded,
    frangi3d_sharded,
    frangi_halo,
    make_mesh,
    normalize_to_u8_sharded,
    seeds_sharded,
    shard_volume,
    slab_filter_route,
)
from pnr_tpu_torch.parallel.batch_dp import (  # after the modules it imports from
    reconstruction_batch_dp,
    reconstruction_batch_sharded,
    split_mesh,
)

__all__ = [
    "Mesh",
    "ShardPlan",
    "allgather_host_rows",
    "assign_seeds_to_shards",
    "build_handoff_trace_step",
    "build_handoff_tracer",
    "build_local_trace_step",
    "build_sharded_step",
    "card_memory_bytes",
    "fetch_replicated",
    "frangi2d_halo",
    "frangi2d_sharded",
    "frangi3d_sharded",
    "frangi_halo",
    "halo_exchange_z",
    "halo_exchange_z_aligned",
    "init_multihost",
    "make_global_mesh",
    "make_mesh",
    "min_devices",
    "normalize_to_u8_sharded",
    "plan_sharded",
    "reconstruction_batch_dp",
    "reconstruction_batch_sharded",
    "required_trace_halo",
    "seeds_sharded",
    "shard_volume",
    "shard_volume_global",
    "shutdown_multihost",
    "slab_filter_route",
    "split_mesh",
    "stitch_estimates",
]
