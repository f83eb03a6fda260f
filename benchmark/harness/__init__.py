"""Shared machinery of the benchmark: manifest, weights, traffic, tracing, checks."""
