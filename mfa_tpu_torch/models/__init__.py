"""Llama over the port's kernels."""
