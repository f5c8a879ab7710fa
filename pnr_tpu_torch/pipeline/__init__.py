"""The reconstruction pipeline: one stack, a batch of stacks, the
watch-directory server, and one stack over a mesh of devices."""

from pnr_tpu_torch.pipeline.reconstruct import (
    ReconstructionResult,
    reconstruct_graph,
    reconstruction_batch,
    reconstruction_func,
)
from pnr_tpu_torch.pipeline.serve import watch_and_reconstruct
from pnr_tpu_torch.pipeline.sharded_reconstruct import reconstruction_func_sharded

__all__ = [
    "ReconstructionResult",
    "reconstruct_graph",
    "reconstruction_batch",
    "reconstruction_func",
    "reconstruction_func_sharded",
    "watch_and_reconstruct",
]
