"""pnr_tpu_torch — PyTorch/CUDA port of pnr_tpu's single-stack main path.

The JAX package `pnr_tpu` stays the reference; this package runs the same
pipeline (Frangi -> seed flood -> exact-ZNCC seed scoring -> SMC tracer ->
graph post-processing) on PyTorch tensors, with hand-written CUDA kernels
(csrc/) for the two TPU kernels on that path: the fused multi-scale
Frangi and the exact template ZNCC. It imports torch and never jax; the
jax-free host modules of `pnr_tpu` (config, io, native, graph building,
priors, templates, threefry) are shared, not copied.
"""

from pnr_tpu.config import PNRConfig

__all__ = ["PNRConfig"]
