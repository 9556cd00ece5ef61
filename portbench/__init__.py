"""The benchmark of the PyTorch/CUDA port `triple_accel_tpu_torch`
(`BENCHMARK.json` at the checkout's root names its cells and metrics)."""
