"""Mixture-of-Experts FFN: top-k router + sort-based capacity dispatch (the
port of ``repro.models.moe``).

Dispatch is static-shaped: assignments are sorted by expert (a stable sort,
so tokens keep their order within an expert), each expert gets a
``capacity`` of slots, overflow tokens are dropped.  Which tokens an expert
sees depends on that order and on the router's order on ties, so both follow
the reference: the stable sort, and ``lax.top_k``'s lower index first among
equal probabilities.  Each batch row is one dispatch group (the reference's
``vmap`` over rows is a leading batch dim here).

Router: softmax gating over top-k with load-balance + z auxiliary losses,
in float32.  On a mesh of several batch ranks, training takes the
load-balance terms over the whole batch (``parallel.shard.batch_mean``), as
the reference's global arrays do.

On a mesh whose ``model`` axis splits the experts (the reference's pin of
the dispatch at ``("batch", "exp", None, None)``), each ``model`` rank
runs its E/m experts on the slots of its own rows (the ``model`` ranks
hold the same rows, so no all-to-all), adds their gated outputs up, and
``reduce_from_model`` sums the ranks' partial outputs; the shared experts
split their hidden columns as the dense MLP does.  The router, its
top-k and the aux terms run whole on every rank.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, ShardingPlan
from repro_torch.parallel.shard import (batch_mean, copy_to_model,
                                        enter_region, leave_region, tp_rank,
                                        tp_ranks)
from .layers import ParamDef, constrain, f32


def moe_defs(cfg: ArchConfig, dt: str) -> dict:
    d, E, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff or cfg.d_ff
    defs = {
        "router": ParamDef((d, E), ("fsdp", None), dtype="float32"),
        "experts": {
            "w_gate": ParamDef((E, d, f), ("exp", "fsdp", None), dtype=dt),
            "w_up": ParamDef((E, d, f), ("exp", "fsdp", None), dtype=dt),
            "w_down": ParamDef((E, f, d), ("exp", None, "fsdp"), dtype=dt),
        },
    }
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        defs["shared"] = {
            "w_gate": ParamDef((d, fs), ("fsdp", "tp"), dtype=dt),
            "w_up": ParamDef((d, fs), ("fsdp", "tp"), dtype=dt),
            "w_down": ParamDef((fs, d), ("tp", "fsdp"), dtype=dt),
        }
    return defs


def _shared_ff(cfg: ArchConfig) -> int:
    return (cfg.moe_d_ff or cfg.d_ff) * cfg.n_shared_experts


def moe_split(cfg: ArchConfig, plan: ShardingPlan) -> dict:
    """``gather_tree``'s split of an MoE block's leaves: the experts where
    ``model`` splits them, the shared experts where it splits their
    hidden columns."""
    own = (1, False)
    out = {}
    if tp_ranks(plan, "exp", cfg.n_experts) > 1:
        out["experts"] = {k: own for k in ("w_gate", "w_up", "w_down")}
    if cfg.n_shared_experts and tp_ranks(plan, "tp", _shared_ff(cfg)) > 1:
        out["shared"] = {k: own for k in ("w_gate", "w_up", "w_down")}
    return out


def capacity(n_tokens: int, cfg: ArchConfig) -> int:
    c = int(n_tokens * cfg.n_experts_per_tok * cfg.capacity_factor
            / cfg.n_experts)
    return max(8, -(-c // 8) * 8)


def top_k(probs, k: int):
    """``lax.top_k`` over the last dim: the k largest, the lower index
    first among equal values."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _dispatch_group(xg, idx, E: int, C: int, experts=None):
    """Sort-based dispatch of the groups. xg (G,T,d), idx (G,T,k).

    Returns (dispatched (G, E*C, d), slot, keep, t_sorted, order), the last
    four (G, T*k).  ``experts`` = (first, count): only these experts'
    slots are dispatched (slots numbered from the first's), ``keep`` false
    for every other assignment."""
    G, T, d = xg.shape
    k = idx.shape[-1]
    dev = xg.device
    expert = idx.reshape(G, T * k)
    tok = torch.arange(T, device=dev).repeat_interleave(k)
    order = torch.argsort(expert, dim=-1, stable=True)
    e_sorted, t_sorted = torch.gather(expert, 1, order), tok[order]
    counts = torch.zeros((G, E), dtype=torch.int64, device=dev).scatter_add_(
        1, e_sorted, torch.ones_like(e_sorted))
    starts = torch.cumsum(counts, dim=1) - counts              # exclusive
    pos_in_e = (torch.arange(T * k, device=dev)
                - torch.gather(starts, 1, e_sorted))
    keep = pos_in_e < C
    if experts is not None:
        e0, E = experts
        e_sorted = e_sorted - e0
        keep = keep & (e_sorted >= 0) & (e_sorted < E)
    slot = torch.where(keep, e_sorted * C + pos_in_e, E * C)  # dummy slot
    rows = torch.gather(xg, 1, t_sorted[..., None].expand(G, T * k, d))
    dispatched = torch.zeros((G, E * C + 1, d), dtype=xg.dtype, device=dev)
    dispatched.scatter_(1, slot[..., None].expand(G, T * k, d), rows)
    return dispatched[:, :E * C], slot, keep, t_sorted, order


def moe_apply(p, x, cfg: ArchConfig, plan: ShardingPlan):
    """x (B, S, d) -> (B, S, d), aux-loss scalar.

    GShard-style *grouped* dispatch: each batch row is a dispatch group with
    its own capacity C = ceil(S·k·cf / E).  Under a sequence split ``x``
    is this rank's block of the sequence: the router and the aux terms
    run on the whole sequence (``xw``), as the experts do."""
    E, k = cfg.n_experts, cfg.n_experts_per_tok
    m = tp_ranks(plan, "exp", E)
    xw = enter_region(x, False)     # the router runs whole on every rank
    B, S, d = xw.shape
    C = capacity(S, cfg)

    logits = f32(xw) @ p["router"]                             # (B, S, E)
    probs = torch.softmax(logits, dim=-1)
    gate, idx = top_k(probs, k)                                # (B, S, k)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)

    # aux losses: load balance (Switch) + router z-loss (global over tokens)
    me = probs.mean((0, 1))                                     # (E,)
    ce = torch.zeros((E,), dtype=torch.float32, device=x.device).index_add_(
        0, idx.reshape(-1), torch.full((idx.numel(),), 1.0 / (B * S * k),
                                       dtype=torch.float32, device=x.device))
    if torch.is_grad_enabled():
        # on a mesh, the load-balance terms of the whole batch: the mean of
        # the batch ranks' (equal-sized) row means
        me, ce = batch_mean(me, plan), batch_mean(ce, plan)
    aux = E * torch.sum(me * ce)
    zloss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    aux = aux + 1e-3 * zloss

    # ---- per-group sort-based dispatch ------------------------------------
    xe, mine = xw, None
    if m > 1:        # this rank's experts; the replicated input enters
        E = E // m
        xe, mine = enter_region(x, True), (tp_rank() * E, E)
    dispatched, slot, keep, t_sorted, order = _dispatch_group(xe, idx,
                                                              cfg.n_experts,
                                                              C, mine)
    h = dispatched.reshape(B, E, C, d)
    h = constrain(h, plan, ("batch", "exp", None, None))

    # ---- expert computation (grouped einsum) ------------------------------
    eg = p["experts"]
    hidden = F.silu(torch.einsum("gecd,edf->gecf", h, eg["w_gate"])) \
        * torch.einsum("gecd,edf->gecf", h, eg["w_up"])
    out_e = torch.einsum("gecf,efd->gecd", hidden, eg["w_down"])
    out_e = constrain(out_e, plan, ("batch", "exp", None, None))

    # ---- combine -----------------------------------------------------------
    flat = out_e.reshape(B, E * C, d)
    picked = torch.gather(
        flat, 1, torch.clamp(slot, max=E * C - 1)[..., None].expand(
            B, S * k, d))
    gathered = torch.where(keep[..., None], picked, 0)
    g_sorted = torch.gather(gate.reshape(B, S * k), 1, order)
    if m > 1:
        g_sorted = copy_to_model(g_sorted)
    y = torch.zeros((B, S, d), dtype=torch.float32, device=x.device)
    y.scatter_add_(1, t_sorted[..., None].expand(B, S * k, d),
                   f32(gathered) * g_sorted[..., None])

    # the ranks' partial sums (``part``) add up in one all-reduce (or
    # reduce-scatter), beside the terms every rank computes whole (``y``)
    part, y = (y, 0.0) if m > 1 else (None, y)
    if cfg.n_shared_experts:
        sh = p["shared"]
        split = tp_ranks(plan, "tp", _shared_ff(cfg)) > 1
        xr = (enter_region(x, True) if split else xw).reshape(B * S, d)
        ys = f32(F.silu(xr @ sh["w_gate"]) * (xr @ sh["w_up"])
                 @ sh["w_down"]).reshape(B, S, d)
        if split:
            part = ys if part is None else part + ys
        else:
            y = y + ys
    if isinstance(y, torch.Tensor):
        y = leave_region(y, False)
    if part is not None:
        y = y + leave_region(part, True)

    y = y.to(x.dtype).reshape(x.shape)
    return constrain(y, plan, ("batch", None, "fsdp")), aux
