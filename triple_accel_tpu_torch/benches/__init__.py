"""Measurement scripts of the port; each needs a CUDA device and nvcc."""
