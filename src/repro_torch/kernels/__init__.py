"""Hand-written CUDA kernels for the serving path and their plain versions."""
