"""Tensor ops of the port: the two CUDA kernels' wrappers and plain torch ops."""
