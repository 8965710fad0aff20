"""The port's PyTorch and CUDA benchmark (see PERF.md)."""
