"""Sparse weight kernels: CUDA on a CUDA tensor, plain PyTorch on the CPU."""
