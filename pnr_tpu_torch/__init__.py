"""pnr_tpu_torch — PyTorch/CUDA port of pnr_tpu's single-stack main path.

The JAX package `pnr_tpu` stays the reference; this package runs the same
pipeline (Frangi -> seed flood -> seed scoring -> SMC tracer -> graph
post-processing) on PyTorch tensors, in exact and in tube mode, with
hand-written CUDA kernels (csrc/) for the TPU kernels on those paths: the
fused multi-scale Frangi, the 1-D and fused y-x correlations of the
unfused and tiled Frangi, the exact template ZNCC and the tube-map hat
sampling of a patch and of the field. It imports torch, and nothing of
jax or of `pnr_tpu`: the host modules it needs (config, io, native, graph
building, priors, ZNCC model tables, threefry, exporters) are copies of
the JAX package's, under the same module names.
"""

from pnr_tpu_torch.config import PNRConfig

__all__ = ["PNRConfig"]
