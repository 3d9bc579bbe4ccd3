"""Benchmarks of the port (``model_bench``: the training step)."""
