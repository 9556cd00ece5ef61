"""Device operations of the port: each module holds one hand-written CUDA kernel, its plain PyTorch version and its wrapper."""
