"""PyTorch/CUDA port of the distributed graph coloring system (``repro``).

Imports torch and numpy only — never jax, never ``repro``.  See
``repro_torch.core`` for the public API.
"""
