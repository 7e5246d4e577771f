"""Parameter definitions + elementary layers (the port of
``repro.models.layers``).

Parameters live in a nested ``{name: tensor}`` dict whose paths are the
reference's.  Each architecture declares a nested ``{name: ParamDef}`` table
(shape, dtype, init scale, logical sharding dims); from that single table
come the initialization, the parameter count and the sharding specs
(``ShardingPlan.spec`` of a definition's dims and shape).
``init_params`` draws from an explicit ``torch.Generator``: the same seed
gives the same weights on every run of one device type, not the
reference's threefry numbers (tests carry the reference's parameters
across with ``models.convert.params_from_numpy``).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ShardingPlan

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "int32": torch.int32}


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    dims: tuple[str | None, ...]          # logical sharding per dim
    init: str = "normal"                  # normal | zeros | ones
    scale: float | None = None            # None -> 1/sqrt(fan_in)
    dtype: str = "bfloat16"

    def initializer(self, generator: torch.Generator | None, device=None):
        """The tensor of this definition; ``normal`` draws N(0, 1) in
        float32 from ``generator`` (on ``device``'s type), scales it by
        ``scale`` or 1/sqrt(fan_in), and casts to ``dtype``."""
        dt = DTYPES[self.dtype]
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=dt, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=dt, device=device)
        fan_in = self.shape[-2] if len(self.shape) >= 2 else self.shape[-1]
        scale = self.scale if self.scale is not None else 1.0 / math.sqrt(fan_in)
        x = torch.randn(self.shape, generator=generator, dtype=torch.float32,
                        device=device)
        return (x * scale).to(dt)


def flatten(tree: dict, prefix: str = "") -> dict:
    """``{"a/b/c": leaf}`` of a nested dict (leaves are non-dicts)."""
    flat = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            flat.update(flatten(v, path))
        else:
            flat[path] = v
    return flat


def unflatten(flat: dict) -> dict:
    """The nested dict of ``flatten``'s ``{"a/b/c": leaf}``."""
    tree: dict = {}
    for path, v in flat.items():
        *head, last = path.split("/")
        node = tree
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return tree


def tree_map(fn, tree):
    """``fn`` over the leaves of a nested dict, keeping its paths."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def init_params(defs: dict, generator: torch.Generator | None,
                device=None, place=None) -> dict:
    """Initialised tensors of a (nested or flat) ``ParamDef`` table, drawn
    from ``generator`` one definition after another in sorted path order
    (the reference's order); returns the same nesting.  ``place(path,
    tensor)``, when given, is kept in place of each whole tensor as soon
    as it is drawn (a rank's shard of it)."""
    flat = flatten(defs)
    out = {}
    for name in sorted(flat):
        t = flat[name].initializer(generator, device)
        out[name] = t if place is None else place(name, t)
    return unflatten(out)


def specs_of(defs: dict, plan: ShardingPlan) -> dict:
    """``plan.spec`` of every definition of a (nested) ``ParamDef`` table."""
    return tree_map(lambda d: plan.spec(d.dims, d.shape), defs)


def count_params(defs: dict) -> int:
    return int(sum(np.prod(d.shape) for d in flatten(defs).values()))


# --------------------------------------------------------------------------
# Elementary ops (all take explicit params, compute dtype from inputs)


def f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32)


def rms_norm(x, gamma, eps: float = 1e-6):
    dt = x.dtype
    x = f32(x)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * f32(gamma)).to(dt)


def layer_norm(x, gamma, beta, eps: float = 1e-5):
    dt = x.dtype
    x = f32(x)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * f32(gamma) + f32(beta)).to(dt)


def rope_freqs(head_dim: int, theta: float):
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


def _rotate(x, ang):
    """Half-split rotation of x (..., S, H, D) by angles (..., S, D/2)."""
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(f32(x), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x, pos, theta: float = 1e4):
    """x (..., S, H, D), pos (..., S) -> rotated x (half-split convention)."""
    freqs = torch.tensor(rope_freqs(x.shape[-1], theta), dtype=torch.float32,
                         device=x.device)                       # (D/2,)
    return _rotate(x, f32(pos[..., None]) * freqs)


def apply_m_rope(x, pos3, sections: tuple[int, int, int], theta: float = 1e4):
    """Qwen2-VL M-RoPE: pos3 (3, ..., S); `sections` split D/2 among t/h/w."""
    d = x.shape[-1]
    freqs = torch.tensor(rope_freqs(d, theta), dtype=torch.float32,
                         device=x.device)                       # (D/2,)
    sec = np.cumsum((0,) + tuple(sections))
    if sec[-1] != d // 2:
        raise ValueError(f"M-RoPE sections {sections} != head_dim/2 {d // 2}")
    stream = np.zeros(d // 2, np.int64)
    for i in range(3):
        stream[sec[i]:sec[i + 1]] = i
    pos = pos3[torch.from_numpy(stream).to(pos3.device)]        # (D/2, ..., S)
    pos = torch.movedim(pos, 0, -1)                             # (..., S, D/2)
    return _rotate(x, f32(pos) * freqs)


def sinusoidal_from_pos(pos, d_model: int):
    """pos (..., S) int -> (..., S, d_model) sinusoidal embedding (f32)."""
    half = d_model // 2
    inv = torch.tensor(1.0 / (10000 ** (np.arange(half) / half)),
                       dtype=torch.float32, device=pos.device)
    ang = f32(pos[..., None]) * inv
    out = torch.zeros(pos.shape + (d_model,), dtype=torch.float32,
                      device=pos.device)
    out[..., 0::2] = torch.sin(ang)
    out[..., 1::2] = torch.cos(ang)
    return out


def swiglu(x, w_gate, w_up, w_down):
    h = F.silu(x @ w_gate) * (x @ w_up)
    return h @ w_down


def geglu(x, w_gate, w_up, w_down):
    h = F.gelu(x @ w_gate, approximate="tanh") * (x @ w_up)
    return h @ w_down


def constrain(x, plan: ShardingPlan, dims: tuple[str | None, ...]):
    """The reference's sharding constraint: a no-op in the port.  On a
    mesh the placement is by storage, not by constraint: parameters,
    optimizer state, batches and caches are stored as this rank's shards
    (``parallel.shard``), and a layer's activations are this rank's batch
    rows computed on its gathered weights."""
    return x
