"""The reconstruction pipeline: one stack, a batch of stacks, and the
watch-directory server."""

from pnr_tpu_torch.pipeline.reconstruct import (
    ReconstructionResult,
    reconstruct_graph,
    reconstruction_batch,
    reconstruction_func,
)
from pnr_tpu_torch.pipeline.serve import watch_and_reconstruct

__all__ = [
    "ReconstructionResult",
    "reconstruct_graph",
    "reconstruction_batch",
    "reconstruction_func",
    "watch_and_reconstruct",
]
