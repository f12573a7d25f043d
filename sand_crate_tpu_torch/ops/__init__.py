"""Pair kernels of the PyTorch port (hand-written CUDA, with plain torch twins)."""
