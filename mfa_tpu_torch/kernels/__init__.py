"""Hand-written CUDA kernels (csrc/) with their launch wrappers and plain versions."""
