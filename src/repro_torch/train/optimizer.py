"""AdamW from the reference's formula (the port of
``repro.train.optimizer``): nested-dict states, a dtype policy, global clip.

Not ``torch.optim.AdamW``: the reference clips by the global norm inside
the step, takes the learning rate from the step count, applies the bias
corrections as ``lr·(m/c1)/(sqrt(v/c2)+eps)``, decays only tensors of two
or more dims (a stacked ``(L, d)`` norm gain is one of them) and keeps m
and v in ``state_dtype`` (``"bfloat16"`` halves the state).  The update
returns new trees and leaves its inputs as they were.

Every walk over a tree goes in sorted-key order, the order of the
reference's ``jax.tree.leaves``, so float32 sums add their terms in the
reference's order.  The count and the learning rate stay 0-d tensors on
the parameters' device: a step reads nothing back to the host.

On a mesh every tree holds this rank's shards (``init_opt_state`` makes m
and v like the parameters, ``opt_state_defs`` carries their dims): the
update is elementwise and runs on the shards as it is; only the clip's
global norm reduces over the ranks.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.parallel.shard import ShardedLeaf, all_reduce, current_mesh
from repro_torch.models.layers import DTYPES, ParamDef, tree_map


@dataclasses.dataclass(frozen=True)
class OptConfig:
    peak_lr: float = 3e-4
    min_lr_frac: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"


def leaves(tree) -> list:
    """The leaves of a nested dict in sorted-key order (``jax.tree.leaves``'
    order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


def unleaves(tree, values) -> dict:
    """The tree of ``tree``'s shape holding ``values`` (in ``leaves``'
    order)."""
    it = iter(values)

    def rec(node):
        if isinstance(node, dict):
            return {k: rec(node[k]) for k in sorted(node)}
        return next(it)
    return rec(tree)


def value_and_grad(fn, params, *args):
    """``jax.value_and_grad(fn, has_aux=True)(params, *args)`` by
    ``torch.autograd``: ``fn(p, *args) -> (loss, aux)`` runs on leaf
    copies of ``params`` that require grad.  Returns (loss, aux, grads):
    the loss and a dict ``aux``'s tensors detached, the grads a tree of
    ``params``' shape and dtypes."""
    p = tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss, aux = fn(p, *args)
    grads = torch.autograd.grad(loss, leaves(p))
    if isinstance(aux, dict):
        aux = {k: v.detach() if isinstance(v, torch.Tensor) else v
               for k, v in aux.items()}
    return loss.detach(), aux, unleaves(p, grads)


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def lr_at(step, cfg: OptConfig):
    """Linear warmup + cosine decay to min_lr_frac (a 0-d float32 tensor
    on ``step``'s device)."""
    step = torch.as_tensor(step).to(torch.float32)
    dev = step.device
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.peak_lr * (cfg.min_lr_frac + (1 - cfg.min_lr_frac)
                         * 0.5 * (1 + torch.cos(_f32(math.pi, dev) * t)))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def opt_state_defs(pdefs, cfg: OptConfig) -> dict:
    """ParamDef table of the optimizer state."""
    def mv(d: ParamDef) -> ParamDef:
        return ParamDef(d.shape, d.dims, init="zeros", dtype=cfg.state_dtype)
    return {"m": tree_map(mv, pdefs), "v": tree_map(mv, pdefs),
            "count": ParamDef((), (), init="zeros", dtype="int32")}


def init_opt_state(params, cfg: OptConfig):
    dt = DTYPES[cfg.state_dtype]
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)  # noqa: E731
    device = leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def _over_shards(sums: list, specs: list, rm) -> list:
    """Each leaf's sum of squares over its whole tensor: one all-reduce
    over all the mesh's axes, in which each leaf's sum counts on the
    ranks at coordinate 0 of the axes that replicate it (one copy of each
    distinct shard) and is 0 on the others."""
    keep = [s if all(rm.coord[a] == 0 for a in ShardedLeaf.of(
        (), spec, rm.names).replicated) else torch.zeros_like(s)
        for s, spec in zip(sums, specs)]
    return list(all_reduce(torch.stack(keep), rm, rm.names).unbind(0))


def global_norm(tree, specs=None) -> torch.Tensor:
    """sqrt of the sum of squares over the leaves, in float32, summed leaf
    by leaf in sorted-key order.  On the ambient mesh (``parallel.shard``)
    with the leaves' ``specs``, each leaf's sum is over its whole tensor:
    its distinct shards' sums added over the mesh (``_over_shards``)."""
    sums = [torch.sum(torch.square(x.to(torch.float32)))
            for x in leaves(tree)]
    rm = current_mesh()
    if rm is not None and specs is not None:
        sums = _over_shards(sums, leaves(specs), rm)
    total = None
    for s in sums:
        total = s if total is None else total + s
    return torch.sqrt(total)


# a leaf's float32 temporaries of the update stay within this many elements
UPDATE_BLOCK = 1 << 26


@torch.no_grad()
def adamw_update(params, grads, opt_state, cfg: OptConfig, *, specs=None):
    """One AdamW step; returns (params, opt_state, info) as new trees.  On
    a mesh, the trees are this rank's shards and ``specs`` the parameters'
    spec tree (for the clip's global norm); the update is elementwise."""
    count = opt_state["count"] + 1
    gnorm = global_norm(grads, specs)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = lr_at(count, cfg)
    cf = count.to(torch.float32)
    dev = cf.device
    c1 = 1.0 - torch.pow(_f32(cfg.b1, dev), cf)
    c2 = 1.0 - torch.pow(_f32(cfg.b2, dev), cf)

    def step(p, g, m, v, decay: bool):
        g = g.to(torch.float32) * scale
        m32, v32 = m.to(torch.float32), v.to(torch.float32)
        m32 = cfg.b1 * m32 + (1 - cfg.b1) * g
        v32 = cfg.b2 * v32 + (1 - cfg.b2) * g * g
        step_ = lr * (m32 / c1) / (torch.sqrt(v32 / c2) + cfg.eps)
        if decay:
            step_ = step_ + lr * cfg.weight_decay * p.to(torch.float32)
        return ((p.to(torch.float32) - step_).to(p.dtype),
                m32.to(m.dtype), v32.to(v.dtype))

    def upd(p, g, m, v):
        decay = p.ndim >= 2           # decoupled weight decay on matrices only
        if p.numel() <= UPDATE_BLOCK:
            return step(p, g, m, v, decay)
        # a large leaf in blocks of its elements: the same values
        out = tuple(torch.empty(t.shape, dtype=t.dtype, device=t.device)
                    for t in (p, m, v))
        ins = [t.reshape(-1) for t in (p, g, m, v)]
        for r in range(0, p.numel(), UPDATE_BLOCK):
            for o, u in zip(out, step(*(t[r:r + UPDATE_BLOCK] for t in ins),
                                      decay)):
                o.view(-1)[r:r + UPDATE_BLOCK] = u
        return out

    out = [upd(*xs) for xs in zip(leaves(params), leaves(grads),
                                  leaves(opt_state["m"]),
                                  leaves(opt_state["v"]))]
    new = [unleaves(params, [o[i] for o in out]) for i in range(3)]
    return new[0], {"m": new[1], "v": new[2], "count": count}, \
        {"grad_norm": gnorm, "lr": lr}
