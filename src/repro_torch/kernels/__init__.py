"""Color-selection and conflict kernels: hand-written CUDA for Hopper
(``csrc/``) and their plain PyTorch versions (``ref.py``), behind
``ops.select_colors`` / ``ops.detect_conflicts``, the fused run form of
the selection, ``ops.select_run`` / ``ops.recolor_run``, and the fused
frontier form of the repair, ``ops.detect_conflicts_frontier``."""
