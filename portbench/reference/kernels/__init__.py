"""Plain PyTorch versions of the port's kernels (no CUDA source)."""
