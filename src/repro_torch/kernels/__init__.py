"""Hand-written CUDA kernels for Hopper (``csrc/``), each with a plain
PyTorch version beside it; ``ops`` holds the public wrappers."""
