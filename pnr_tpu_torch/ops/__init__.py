"""Dense operators and the two hand-written CUDA kernels (K1, K2)."""
