"""Consumers of the coloring library (the PyTorch port)."""
