"""Plain PyTorch references of the benchmark's cells.  They import
nothing of the program and nothing of JAX."""
