"""LRP primitives, conv/pool rules and the hand-written CUDA kernels."""
