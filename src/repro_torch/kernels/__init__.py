"""Color-selection and conflict kernels: hand-written CUDA for Hopper
(``csrc/``) and their plain PyTorch versions (``ref.py``), behind
``ops.select_colors`` / ``ops.detect_conflicts``."""
