"""The single-stack reconstruction pipeline."""

from pnr_tpu_torch.pipeline.reconstruct import (
    ReconstructionResult,
    reconstruct_graph,
    reconstruction_func,
)

__all__ = ["ReconstructionResult", "reconstruct_graph", "reconstruction_func"]
