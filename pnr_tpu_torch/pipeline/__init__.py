"""The reconstruction pipeline: one stack, a batch of stacks, the
watch-directory server, and one stack over a mesh of devices."""

from pnr_tpu_torch.pipeline.reconstruct import (
    ReconstructionResult,
    reconstruct_graph,
    reconstruction_batch,
    reconstruction_func,
    soma_extraction,
)
from pnr_tpu_torch.pipeline.serve import watch_and_reconstruct
from pnr_tpu_torch.pipeline.sharded_reconstruct import reconstruction_func_sharded

__all__ = [
    "ReconstructionResult",
    "reconstruct_graph",
    "reconstruction_batch",
    "reconstruction_func",
    "reconstruction_func_sharded",
    "soma_extraction",
    "watch_and_reconstruct",
]
