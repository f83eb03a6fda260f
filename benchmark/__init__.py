"""Benchmark of the PyTorch/CUDA port `neutts_tpu_torch` (see PERF.md)."""
