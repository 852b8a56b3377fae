"""Kernel wrappers (Hopper kernel on CUDA tensors, plain PyTorch on CPU
tensors), the mask predicates and the chunked-CSR metadata."""
