"""Sequential Monte Carlo tracer (the reference's L4 layer, tracker.cpp)."""

from pnr_tpu_torch.smc.directions import generate_directions, nearest_direction
from pnr_tpu_torch.smc.priors import PriorTables, build_prior_tables
from pnr_tpu_torch.smc.tracker import BatchedTracker, TraceResult

__all__ = [
    "generate_directions",
    "nearest_direction",
    "PriorTables",
    "build_prior_tables",
    "BatchedTracker",
    "TraceResult",
]
