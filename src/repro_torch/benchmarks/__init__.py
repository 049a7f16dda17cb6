"""Benchmark twins of the JAX package's ``benchmarks/`` scripts."""
