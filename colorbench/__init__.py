"""The benchmark of the PyTorch port (``repro_torch``): the repeated solve
of a resident graph.  See ``README.md``."""
