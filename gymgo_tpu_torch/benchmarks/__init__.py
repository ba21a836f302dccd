"""Benchmarks of the port, each run as ``python -m
gymgo_tpu_torch.benchmarks.<name>``."""
