"""Carrying parameters across: the reference's parameter tree (a nested dict
of numpy arrays, e.g. ``jax.tree.map(np.asarray, params)``) as the port's
tensors, with the same paths."""
from __future__ import annotations

import numpy as np
import torch

from .layers import tree_map


def _tensor(a, device, dtype):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # ml_dtypes' bfloat16: no numpy twin
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))   # a writable copy
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(tree: dict, device, dtype: torch.dtype | None = None
                      ) -> dict:
    """The nested dict of tensors on ``device`` of a nested dict of arrays;
    ``dtype`` casts the floating-point leaves (bf16 -> f32 -> bf16 is
    exact)."""
    return tree_map(lambda a: _tensor(a, device, dtype), tree)
