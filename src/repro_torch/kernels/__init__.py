"""Hand-written CUDA kernels of the port, with their plain PyTorch
versions; `ops` holds the public wrappers."""
