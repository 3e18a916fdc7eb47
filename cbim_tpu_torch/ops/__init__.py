"""Tensor ops of the port: activations, resize, and the CUDA kernels."""
