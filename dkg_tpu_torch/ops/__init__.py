"""Hand-written CUDA kernels: build and launch (``build``), wrappers with plain versions."""
