"""Device-mesh parallelism: halo exchange, the sharded filter, boundary
handoff of traces and the per-card memory planner (one process; the
multi-process runtime is a later slice of the port)."""

from pnr_tpu_torch.parallel.halo import halo_exchange_z, halo_exchange_z_aligned
from pnr_tpu_torch.parallel.handoff import build_handoff_tracer, required_trace_halo
from pnr_tpu_torch.parallel.multihost import fetch_replicated
from pnr_tpu_torch.parallel.plan import ShardPlan, card_memory_bytes, min_devices, plan_sharded
from pnr_tpu_torch.parallel.sharded import (
    Mesh,
    assign_seeds_to_shards,
    frangi2d_halo,
    frangi2d_sharded,
    frangi3d_sharded,
    frangi_halo,
    make_mesh,
    normalize_to_u8_sharded,
    shard_volume,
)

__all__ = [
    "Mesh",
    "ShardPlan",
    "assign_seeds_to_shards",
    "build_handoff_tracer",
    "card_memory_bytes",
    "fetch_replicated",
    "frangi2d_halo",
    "frangi2d_sharded",
    "frangi3d_sharded",
    "frangi_halo",
    "halo_exchange_z",
    "halo_exchange_z_aligned",
    "make_mesh",
    "min_devices",
    "normalize_to_u8_sharded",
    "plan_sharded",
    "required_trace_halo",
    "shard_volume",
]
