"""Gradient compression: int8 error-feedback all-reduce for explicit data
parallelism (the port of ``repro.train.compression``).

Each rank quantizes its local gradient to int8 with a per-tensor scale,
all-reduces the dequantized int8 payload over its process group (4x fewer
bytes on a wire that carries the int8 words and one scale), and keeps the
quantization residual locally as error feedback, added to the next step's
gradient: the EF-SGD / 1-bit-Adam recipe that preserves convergence.  The
reference's ``psum``/``pmean`` over the ``data`` axis of a ``shard_map``
are ``all_reduce`` calls over the group here: a ``ProcessGroup``, the
``data`` dimension of a ``DeviceMesh`` (its only dimension when it has
one), or ``None`` for the whole world.  Without an initialised world the
group is this one process.

Rounding is half to even (``torch.round``), as ``jnp.round``.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.comm import shard_uniform
from .optimizer import leaves, unleaves, value_and_grad


def quantize_int8(x):
    """Symmetric per-tensor int8. Returns (q, scale)."""
    x = x.to(torch.float32)
    scale = torch.clamp(torch.max(torch.abs(x)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.to(torch.float32) * scale


def process_group(axis=None, name: str = "data"):
    """The process group of ``axis`` (see the module docstring)."""
    if hasattr(axis, "get_group"):       # a DeviceMesh
        names = axis.mesh_dim_names or ()
        return axis.get_group(name if name in names else None)
    return axis


def _world(group) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    if dist.is_initialized():
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def compressed_psum(x, err, axis=None):
    """int8 EF all-reduce of one tensor over ``axis``'s group.

    Returns (mean-reduced tensor, new local error residual)."""
    group = process_group(axis)
    g = x.to(torch.float32) + err
    q, scale = quantize_int8(g)
    new_err = g - dequantize_int8(q, scale)
    total = _all_reduce(q.to(torch.float32) * scale, group)
    return total / float(_world(group)), new_err


def compressed_psum_tree(grads, errs, axis=None):
    """``compressed_psum`` of every leaf, in sorted-key order (the
    reference's flatten order, so every rank issues the same calls)."""
    out_g, out_e = [], []
    # every rank holds the same tree, so the same leaves in the same order
    xs = shard_uniform(list(zip(leaves(grads), leaves(errs))))
    for g, e in xs:
        r, ne = compressed_psum(g, e, axis)
        out_g.append(r.to(g.dtype))
        out_e.append(ne)
    return unleaves(grads, out_g), unleaves(grads, out_e)


def wire_bytes(tree) -> tuple[int, int]:
    """(uncompressed f32 AR bytes, int8 EF-AR bytes) for a gradient tree."""
    xs = leaves(tree)
    n = sum(int(x.numel()) for x in xs)
    return 4 * n, n + 4 * len(xs)


def make_compressed_train_step(loss_fn, opt_update, axis=None):
    """Explicit-DP train step with int8 EF gradient all-reduce.

    loss_fn(params, batch) -> (loss, aux); opt_update(params, grads, state)
    -> (params, state, info).  Every rank of ``axis``'s group calls the
    step with its own batch shard; gradients come from ``torch.autograd``
    on leaf copies of the parameters."""
    group = process_group(axis)

    def step(params, opt_state, err, batch):
        loss, _, grads = value_and_grad(loss_fn, params, batch)
        grads, err = compressed_psum_tree(grads, err, group)
        params, opt_state, info = opt_update(params, grads, opt_state)
        loss = _all_reduce(loss.clone(), group) / float(_world(group))
        return params, opt_state, err, {"loss": loss, **info}
    return step
