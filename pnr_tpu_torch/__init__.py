"""pnr_tpu_torch — PyTorch/CUDA port of pnr_tpu's single-stack main path.

The JAX package `pnr_tpu` stays the reference; this package runs the same
pipeline (Frangi -> seed flood -> seed scoring -> SMC tracer -> graph
post-processing) on PyTorch tensors, in exact and in tube mode, with
hand-written CUDA kernels (csrc/) for the TPU kernels on those paths: the
fused multi-scale Frangi, the exact template ZNCC and the tube-map hat
sampling of a patch and of the field. It imports torch and never jax; the
jax-free host modules of `pnr_tpu` (config, io, native, graph building,
priors, ZNCC model tables, threefry) are shared, not copied.
"""

from pnr_tpu.config import PNRConfig

__all__ = ["PNRConfig"]
