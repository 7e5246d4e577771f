"""Model assembly: layer plans, parameter tables, train/prefill/decode (the
port of ``repro.models.model``).

An architecture lowers to a list of *runs*: maximal contiguous groups of
identical (mixer, ffn) layer specs.  Each run's parameters (and caches) are
stacked on a leading L axis, the reference's layout, so carrying the
reference's weights across is a copy; a Python loop over the run's L layers
takes the place of its ``lax.scan``.  Heterogeneous stacks (jamba's 1:7
mamba:attention interleave with alternating MoE) produce many short runs.

Modes: ``train`` (the full forward, no cache; ``loss_fn`` is the training
loss), ``prefill`` (build caches + last-position logits), ``decode`` (one
token against ring-buffer caches).  Caches are updated in place: a layer
writes into its slice of the run's stacked cache tensors.

Training recomputes instead of storing, as the reference does: with
``cfg.remat`` each layer of a run is a ``torch.utils.checkpoint`` region
(the reference's ``jax.checkpoint`` with ``nothing_saveable`` around its
scan body), so the backward pass keeps one residual per layer; the loss's
(B, chunk, V) logits are recomputed per sequence chunk.

On a mesh (``parallel.shard.set_mesh``) the parameters are this rank's
shards under ``plan.spec`` and the batch (and caches) this rank's rows.
A layer gathers its weights just before it runs and drops them after
(``parallel.shard.GatherLayer``: all-gather forward, reduce-scatter
backward), inside the remat region, so the recompute gathers again and
at most one layer's gathered weights are live; the embedding, the final
norms and the unembedding gather the same way.  Without a mesh nothing
is gathered.

Where the mesh's ``model`` axis splits a region's compute (the query
heads, the MLP's hidden columns, the experts, the vocabulary: wherever
``plan.spec`` keeps ``model`` on the activation the reference pins, or,
for the MLP, on its hidden dim), the region gathers its leaves only over
the batch axes and runs on its own block (``_block_split``): the
vocabulary-parallel lookup and cross entropy below, the head split in
``attention``, the expert split in ``moe``, the head and channel splits of
RWKV-6 and Mamba in ``ssm``.  ``prefill`` and ``decode_step`` return
logits gathered over ``model``.

With ``cfg.seq_parallel_acts``, in train mode, where the plan keeps
``model`` on the sequence (``_seq_split``), the residual stream is this
rank's block of the sequence (``parallel.shard.split_sequence``): the
embedding's sum is reduce-scattered to it, each remat region saves it
(1/m of the residual), the norms run on it, every mixer and FFN region
gathers the whole sequence where it enters and reduce-scatters its output
where it leaves (``enter_region`` / ``leave_region``; token shifts,
convolutions and recurrences run on the whole sequence), and the loss
gathers it before the cross entropy.  The encoder's stack is split the
same way, in prefill too, and its output gathered whole.

The decode caches are stored as the reference's plan places them: each
leaf at this rank's block of ``plan.spec`` of all its dims
(``init_cache``), so a rank holds its heads of RWKV-6's ``state``, its
``di`` channels of Mamba's ``conv`` and ``h``, and, where the batch is
too small for ``data`` (batch 1 on a mesh with ``data`` > 1), its block
of the attention caches' slots, over which ``attention`` decodes (the
``seq`` axes).  A cache's layout follows from the global batch and the
cache length, which ``prefill`` and ``decode_step`` take beside this
rank's rows.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import NO_SHARDING, ArchConfig, ShardingPlan
from repro_torch.parallel.shard import (copy_to_model, current_mesh,
                                        enter_region, gather_model,
                                        gather_tree, in_this_context,
                                        leave_region, local_shape,
                                        max_over_model, reduce_from_model,
                                        seq_axes, sequence_split,
                                        sequence_start, split_sequence,
                                        tp_rank, tp_ranks)
from . import attention as attn
from . import moe as moe_mod
from . import ssm
from .layers import (DTYPES, ParamDef, constrain, flatten, geglu, layer_norm,
                     rms_norm, sinusoidal_from_pos, swiglu, tree_map)


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    mixer: str            # gqa | mla | rwkv6 | mamba | none
    ffn: str              # swiglu | geglu | mlp | moe | rwkv
    cross: bool = False   # whisper decoder cross-attention
    causal: bool = True


# --------------------------------------------------------------------------
# Layer plans


def layer_specs(cfg: ArchConfig) -> list[BlockSpec]:
    """Per-layer BlockSpec for the decoder/backbone stack."""
    specs = []
    for i in range(cfg.n_layers):
        if cfg.family == "hybrid":
            mixer = "gqa" if cfg.attn_every and i % cfg.attn_every == (
                cfg.attn_every // 2) else "mamba"
            ffn = "moe" if cfg.moe_every and i % cfg.moe_every == 1 else \
                cfg.ffn_kind
        elif cfg.family == "ssm":
            mixer, ffn = cfg.ssm_kind, cfg.ffn_kind
        else:
            mixer = cfg.attn_kind
            ffn = "moe" if (cfg.is_moe and i >= cfg.first_k_dense) else \
                cfg.ffn_kind
        specs.append(BlockSpec(mixer=mixer, ffn=ffn,
                               cross=cfg.enc_dec, causal=True))
    return specs


def layer_runs(cfg: ArchConfig) -> list[tuple[BlockSpec, int]]:
    runs: list[tuple[BlockSpec, int]] = []
    for s in layer_specs(cfg):
        if runs and runs[-1][0] == s:
            runs[-1] = (s, runs[-1][1] + 1)
        else:
            runs.append((s, 1))
    return runs


def encoder_runs(cfg: ArchConfig) -> list[tuple[BlockSpec, int]]:
    if not cfg.enc_dec:
        return []
    return [(BlockSpec(mixer="gqa", ffn="mlp", causal=False),
             cfg.n_enc_layers)]


# --------------------------------------------------------------------------
# Parameter tables


def _norm_defs(cfg: ArchConfig, dt: str) -> dict:
    if cfg.enc_dec:  # whisper uses LayerNorm
        return {"gamma": ParamDef((cfg.d_model,), (None,), init="ones",
                                  dtype=dt),
                "beta": ParamDef((cfg.d_model,), (None,), init="zeros",
                                 dtype=dt)}
    return {"gamma": ParamDef((cfg.d_model,), (None,), init="ones", dtype=dt)}


def _apply_norm(p, x, cfg: ArchConfig):
    if "beta" in p:
        return layer_norm(x, p["gamma"], p["beta"])
    return rms_norm(x, p["gamma"], cfg.rms_eps)


def _mixer_defs(kind: str, cfg: ArchConfig, dt: str) -> dict:
    if kind == "gqa":
        return attn.gqa_defs(cfg, dt)
    if kind == "mla":
        return attn.mla_defs(cfg, dt)
    if kind == "rwkv6":
        return ssm.rwkv6_defs(cfg, dt)
    if kind == "mamba":
        return ssm.mamba_defs(cfg, dt)
    return {}


def _ffn_defs(kind: str, cfg: ArchConfig, dt: str) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    if kind in ("swiglu", "geglu"):
        return {"w_gate": ParamDef((d, f), ("fsdp", "tp"), dtype=dt),
                "w_up": ParamDef((d, f), ("fsdp", "tp"), dtype=dt),
                "w_down": ParamDef((f, d), ("tp", "fsdp"), dtype=dt)}
    if kind == "mlp":
        return {"w1": ParamDef((d, f), ("fsdp", "tp"), dtype=dt),
                "w2": ParamDef((f, d), ("tp", "fsdp"), dtype=dt)}
    if kind == "moe":
        return moe_mod.moe_defs(cfg, dt)
    if kind == "rwkv":
        return ssm.rwkv6_ffn_defs(cfg, dt)
    raise ValueError(kind)


def block_defs(spec: BlockSpec, cfg: ArchConfig, dt: str) -> dict:
    defs = {
        "norm1": _norm_defs(cfg, dt),
        "mixer": _mixer_defs(spec.mixer, cfg, dt),
        "norm2": _norm_defs(cfg, dt),
        "ffn": _ffn_defs(spec.ffn, cfg, dt),
    }
    if spec.cross:
        defs["norm_x"] = _norm_defs(cfg, dt)
        defs["cross"] = attn.gqa_defs(cfg, dt)
    return defs


def _stack_defs(tree, L: int):
    return tree_map(lambda d: ParamDef((L,) + d.shape, (None,) + d.dims,
                                       d.init, d.scale, d.dtype), tree)


def param_defs(cfg: ArchConfig) -> dict:
    dt = cfg.params_dtype
    V = cfg.vocab_padded()
    d = cfg.d_model
    defs: dict[str, Any] = {
        "embed": ParamDef((V, d), ("tp", "fsdp"), scale=1.0, dtype=dt),
        "final_norm": _norm_defs(cfg, dt),
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((d, V), ("fsdp", "tp"), dtype=dt)
    for r, (spec, L) in enumerate(layer_runs(cfg)):
        defs[f"run{r}"] = _stack_defs(block_defs(spec, cfg, dt), L)
    if cfg.enc_dec:
        for r, (spec, L) in enumerate(encoder_runs(cfg)):
            defs[f"enc_run{r}"] = _stack_defs(block_defs(spec, cfg, dt), L)
        defs["enc_final_norm"] = _norm_defs(cfg, dt)
    return defs


# --------------------------------------------------------------------------
# Caches


def _mixer_cache_defs(kind: str, cfg: ArchConfig, B: int, S: int) -> dict:
    d = cfg.d_model
    dt = cfg.compute_dtype
    if kind == "gqa":
        hkv, hd = cfg.n_kv_heads, cfg.head_dim_
        return {"k": ParamDef((B, S, hkv, hd), ("batch", "seq", None, None),
                              init="zeros", dtype=dt),
                "v": ParamDef((B, S, hkv, hd), ("batch", "seq", None, None),
                              init="zeros", dtype=dt)}
    if kind == "mla":
        return {"c_kv": ParamDef((B, S, cfg.kv_lora_rank),
                                 ("batch", "seq", None), init="zeros",
                                 dtype=dt),
                "k_rope": ParamDef((B, S, cfg.qk_rope_dim),
                                   ("batch", "seq", None), init="zeros",
                                   dtype=dt)}
    if kind == "rwkv6":
        H = max(d // 64, 1)
        return {"x_prev": ParamDef((B, 1, d), ("batch", None, None),
                                   init="zeros", dtype=dt),
                "state": ParamDef((B, H, d // H, d // H),
                                  ("batch", "tp", None, None), init="zeros",
                                  dtype="float32")}
    if kind == "mamba":
        di = cfg.expand * d
        return {"conv": ParamDef((B, cfg.d_conv - 1, di),
                                 ("batch", None, "tp"), init="zeros",
                                 dtype=dt),
                "h": ParamDef((B, di, cfg.d_state), ("batch", "tp", None),
                              init="zeros", dtype="float32")}
    return {}


def cache_defs(cfg: ArchConfig, B: int, S: int) -> dict:
    """Nested ParamDef table for the decode cache (stacked per run)."""
    out: dict[str, Any] = {"pos": ParamDef((), (), init="zeros",
                                           dtype="int32")}
    for r, (spec, L) in enumerate(layer_runs(cfg)):
        entry = {"mixer": _mixer_cache_defs(spec.mixer, cfg, B, S)}
        if spec.ffn == "rwkv":
            entry["ffn"] = {"x_prev": ParamDef((B, 1, cfg.d_model),
                                               ("batch", None, None),
                                               init="zeros",
                                               dtype=cfg.compute_dtype)}
        if spec.cross:
            hkv, hd = cfg.n_kv_heads, cfg.head_dim_
            E = cfg.enc_len
            entry["cross"] = {
                "k": ParamDef((B, E, hkv, hd), ("batch", None, None, None),
                              init="zeros", dtype=cfg.compute_dtype),
                "v": ParamDef((B, E, hkv, hd), ("batch", None, None, None),
                              init="zeros", dtype=cfg.compute_dtype)}
        out[f"run{r}"] = _stack_defs(entry, L)
    return out


def init_cache(cfg: ArchConfig, B: int, S: int, device=None,
               plan: ShardingPlan = NO_SHARDING):
    """Zero caches for a batch of ``B`` and ``S`` slots (both global): on
    the ambient mesh each leaf at this rank's block of ``plan.spec`` of
    its dims."""
    rm = current_mesh()

    def zeros(d):
        shape = d.shape
        if rm is not None:
            shape = local_shape(shape, plan.spec(d.dims, d.shape), rm.sizes)
        return torch.zeros(shape, dtype=DTYPES[d.dtype], device=device)
    return tree_map(zeros, cache_defs(cfg, B, S))


def cache_seq(cfg: ArchConfig, plan: ShardingPlan, B: int,
              S: int | None) -> tuple[str, ...]:
    """The mesh axes that split the attention caches' slots for a global
    batch ``B`` and ``S`` slots (``seq_axes`` of their dims).  ``S=None``:
    the cache length is not known; raises if the plan could split it."""
    for d in flatten(cache_defs(cfg, B, S or 0)).values():
        if "seq" in d.dims:
            axes = seq_axes(plan, d.dims, d.shape)
            if S is None and axes:
                raise ValueError("this cache's slots may be split over "
                                 f"{axes}: pass its cache_len")
            return axes
    return ()


def batch_size(B: int, plan: ShardingPlan, given: int | None = None) -> int:
    """The global batch of this rank's ``B`` rows: ``given``, else ``B``
    times the ambient mesh's batch ranks (the batch split over all of
    them)."""
    rm = current_mesh()
    if given is not None or rm is None:
        return given or B
    return B * rm.size(rm.batch_axes(plan))


# --------------------------------------------------------------------------
# Forward


def _apply_mixer(spec: BlockSpec, p, h, pos, cfg, plan, mode, cache,
                 cache_pos, pos3, seq=()):
    if spec.mixer == "gqa":
        return attn.gqa_apply(p, h, pos, cfg, plan, causal=spec.causal,
                              mode=mode, cache=cache, cache_pos=cache_pos,
                              pos3=pos3, seq=seq)
    if spec.mixer == "mla":
        return attn.mla_apply(p, h, pos, cfg, plan, mode=mode, cache=cache,
                              cache_pos=cache_pos, seq=seq)
    if spec.mixer == "rwkv6":
        x_prev = cache["x_prev"].to(h.dtype) if cache is not None else \
            torch.zeros_like(h[:, :1])
        H, dk = ssm.rwkv6_heads(cfg), cfg.d_model // ssm.rwkv6_heads(cfg)
        state = cache["state"] if cache is not None else torch.zeros(
            (h.shape[0], H // ssm.rwkv6_ranks(cfg, plan), dk, dk),
            dtype=torch.float32, device=h.device)
        if mode == "decode":
            y, (xl, st) = ssm.rwkv6_step(p, h, x_prev, state, cfg, plan)
        else:
            y, (xl, st) = ssm.rwkv6_chunked(p, h, x_prev, state, cfg, plan)
        new_cache = ({"x_prev": xl.to(DTYPES[cfg.compute_dtype]),
                      "state": st} if mode != "train" else None)
        return y, new_cache
    if spec.mixer == "mamba":
        di = cfg.expand * cfg.d_model // ssm.mamba_ranks(cfg, plan)
        conv = cache["conv"] if cache is not None else torch.zeros(
            (h.shape[0], cfg.d_conv - 1, di), dtype=torch.bfloat16,
            device=h.device)
        hs = cache["h"] if cache is not None else torch.zeros(
            (h.shape[0], di, cfg.d_state), dtype=torch.float32,
            device=h.device)
        y, (conv, hs) = ssm.mamba_apply(p, h, conv, hs, cfg, plan)
        new_cache = {"conv": conv, "h": hs} if mode != "train" else None
        return y, new_cache
    raise ValueError(spec.mixer)


def _dense_split(spec: BlockSpec, cfg: ArchConfig, plan: ShardingPlan) -> int:
    """The ``model`` ranks that split a dense FFN's hidden columns (the
    reference pins no activation there: its split follows the weights'
    ``("fsdp", "tp")``, as GSPMD propagates it)."""
    if spec.ffn not in ("swiglu", "geglu", "mlp"):
        return 1
    return tp_ranks(plan, "tp", cfg.d_ff)


def _apply_ffn(spec: BlockSpec, p, h, cfg, plan, mode, cache):
    if spec.ffn in ("swiglu", "geglu", "mlp"):
        split = _dense_split(spec, cfg, plan) > 1
        h = enter_region(h, split)    # split: column-split up, row-split down
        if spec.ffn == "mlp":
            y = F.gelu(h @ p["w1"], approximate="tanh") @ p["w2"]
        else:
            y = (swiglu if spec.ffn == "swiglu" else geglu)(
                h, p["w_gate"], p["w_up"], p["w_down"])
        return leave_region(y, split), 0.0, None
    if spec.ffn == "moe":
        y, aux = moe_mod.moe_apply(p, h, cfg, plan)
        return y, aux, None
    if spec.ffn == "rwkv":
        x_prev = cache["x_prev"].to(h.dtype) if cache is not None else \
            torch.zeros_like(h[:, :1])
        y, xl = ssm.rwkv6_ffn(p, h, x_prev, cfg, plan)
        new_cache = ({"x_prev": xl.to(DTYPES[cfg.compute_dtype])}
                     if mode != "train" else None)
        return y, 0.0, new_cache
    raise ValueError(spec.ffn)


def apply_block(spec: BlockSpec, p, x, pos, cfg, plan, *, mode,
                cache=None, cache_pos=None, pos3=None, x_enc=None, seq=()):
    """One transformer/SSM block. Returns (x, aux, new_cache).  ``seq``:
    the mesh axes that split the attention caches' slots."""
    c_mix = cache.get("mixer") if cache else None
    c_ffn = cache.get("ffn") if cache else None
    h = _apply_norm(p["norm1"], x, cfg)
    y, new_mix = _apply_mixer(spec, p["mixer"], h, pos, cfg, plan, mode,
                              c_mix, cache_pos, pos3, seq)
    x = x + y
    new_cache: dict[str, Any] = {}
    if new_mix is not None:
        new_cache["mixer"] = new_mix
    if spec.cross:
        h = _apply_norm(p["norm_x"], x, cfg)
        if mode == "train" or (mode == "prefill" and x_enc is not None):
            enc_kv = attn.encode_kv(p["cross"], x_enc, cfg, plan)
        else:
            enc_kv = {"k": cache["cross"]["k"], "v": cache["cross"]["v"]}
        x = x + attn.gqa_cross_apply(p["cross"], h, enc_kv, cfg, plan)
        if mode == "prefill":
            new_cache["cross"] = {k: attn.kv_whole(v, cfg, plan).to(
                DTYPES[cfg.compute_dtype]) for k, v in enc_kv.items()}
        elif mode == "decode":
            new_cache["cross"] = cache["cross"]
    h = _apply_norm(p["norm2"], x, cfg)
    y, aux, new_ffn = _apply_ffn(spec, p["ffn"], h, cfg, plan, mode, c_ffn)
    if new_ffn is not None:
        new_cache["ffn"] = new_ffn
    return x + y, aux, (new_cache if new_cache else None)


def _layer(tree, i: int):
    """Layer ``i``'s slice of a stacked tree (views, no copy); on a mesh,
    of this rank's stacked shards (the L dim is never split)."""
    return tree_map(lambda t: t[i], tree)


def _seq_split(cfg: ArchConfig, plan: ShardingPlan, S: int,
               mode: str) -> bool:
    """Whether a stack of ``mode`` on a sequence of ``S`` keeps its
    residual stream split along the sequence over ``model`` (Megatron-SP,
    the reference's pin of each layer's carry at ``("batch", "act_seq",
    None)``): with ``cfg.seq_parallel_acts``, in train mode, where the
    plan keeps ``model`` on that sequence dim."""
    return (cfg.seq_parallel_acts and mode == "train"
            and tp_ranks(plan, "act_seq", S) > 1)


def _vocab_split(cfg: ArchConfig, plan: ShardingPlan) -> int:
    """The ``model`` ranks that split the vocabulary (the logits' pin at
    ``("batch", None, "tp")``)."""
    return tp_ranks(plan, "tp", cfg.vocab_padded())


def _whole(params, name: str, cfg: ArchConfig, plan: ShardingPlan):
    """``params[name]`` (a leaf or a subtree) gathered on the ambient mesh:
    whole, or, for the (un)embedding of a split vocabulary, this rank's
    vocabulary block; as it is without a mesh.  A final norm under
    ``split_sequence`` runs on this rank's block of the sequence: its
    gradient is summed over ``model``."""
    p = params[name]
    if current_mesh() is None:
        return p
    split = None
    if name in ("embed", "lm_head") and _vocab_split(cfg, plan) > 1:
        split = (1, False)
    elif name in ("final_norm", "enc_final_norm") and sequence_split():
        split = {k: ssm.SUMMED for k in p}
    return gather_tree(p, param_defs(cfg)[name], plan, split)


def _block_split(spec: BlockSpec, cfg: ArchConfig, plan: ShardingPlan):
    """How a block's leaves are gathered where ``model`` splits its
    regions (``gather_tree``'s split); under ``split_sequence`` the norms
    run on this rank's block of the sequence, so each rank's gradient of
    them is a partial sum (summed over ``model``)."""
    out = {}
    if sequence_split():
        for k in ("norm1", "norm2") + (("norm_x",) if spec.cross else ()):
            out[k] = {leaf: ssm.SUMMED
                      for leaf in _norm_defs(cfg, cfg.params_dtype)}
    mixer = {"gqa": attn.gqa_split, "mla": attn.mla_split,
             "rwkv6": ssm.rwkv6_split, "mamba": ssm.mamba_split}.get(
                 spec.mixer)
    if mixer is not None:
        out["mixer"] = mixer(cfg, plan)
    if spec.ffn == "moe":
        out["ffn"] = moe_mod.moe_split(cfg, plan)
    elif spec.ffn == "rwkv":
        out["ffn"] = ssm.rwkv6_ffn_split(cfg, plan)
    elif _dense_split(spec, cfg, plan) > 1:
        own = (1, False)
        out["ffn"] = ({"w1": own, "w2": own} if spec.ffn == "mlp" else
                      {"w_gate": own, "w_up": own, "w_down": own})
    if spec.cross:
        out["cross"] = attn.gqa_split(cfg, plan)
    return out


def gather_splits(cfg: ArchConfig, plan: ShardingPlan) -> dict:
    """Each leaf's ``(keep, summed)`` where a compute split on the ambient
    mesh gathers it (``gather_tree``'s split), by path."""
    out: dict[str, Any] = {}
    for prefix, runs in (("run", layer_runs(cfg)),
                         ("enc_run", encoder_runs(cfg))):
        for r, (spec, _) in enumerate(runs):
            out[f"{prefix}{r}"] = _block_split(spec, cfg, plan)
    if _vocab_split(cfg, plan) > 1:
        for name in ("embed",) + (() if cfg.tie_embeddings else
                                  ("lm_head",)):
            out[name] = (1, False)
    return flatten(out)


def _gathering(spec: BlockSpec, cfg: ArchConfig, plan: ShardingPlan):
    """``apply_block`` on a mesh: the layer's shards are gathered inside
    it (so a remat region saves the shards and its recompute gathers
    again), over ``model`` only where no region of it splits; it runs in
    the caller's context (the mesh, the sequence split), the recompute
    too."""
    if current_mesh() is None:
        return apply_block
    defs = block_defs(spec, cfg, cfg.params_dtype)
    split = _block_split(spec, cfg, plan)

    def run(spec_, p, *args, **kw):
        return apply_block(spec_, gather_tree(p, defs, plan, split), *args,
                           **kw)
    return in_this_context(run)


def _store(stacked: dict, i: int, new: dict) -> None:
    """Write layer ``i``'s new cache into the stacked cache in place (a
    tensor the layer already wrote through its view is left as it is)."""
    for k, v in new.items():
        if isinstance(v, dict):
            _store(stacked[k], i, v)
        else:
            dst = stacked[k][i]
            if v.data_ptr() != dst.data_ptr():
                dst.copy_(v)


def _run_stack(spec: BlockSpec, p_stacked, x, pos, cfg, plan, *, mode,
               cache=None, cache_pos=None, pos3=None, x_enc=None, seq=()):
    """One run, layer by layer (stacked params / caches). Returns (x, aux,
    new_cache): ``cache`` itself, updated in place, when one is given;
    else the layers' caches stacked (``None`` in train mode)."""
    L = next(iter(flatten(p_stacked).values())).shape[0]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    made = []
    # remat: keep only each layer's input for the backward pass
    run = _gathering(spec, cfg, plan)
    block = (functools.partial(checkpoint, run, use_reentrant=False)
             if cfg.remat and mode == "train" else run)
    for i in range(L):
        c_l = _layer(cache, i) if cache is not None else None
        x, a, nc = block(spec, _layer(p_stacked, i), x, pos, cfg, plan,
                         mode=mode, cache=c_l, cache_pos=cache_pos,
                         pos3=pos3, x_enc=x_enc, seq=seq)
        aux = aux + a
        if nc is None:
            continue
        if cache is not None:
            _store(cache, i, nc)
        else:
            made.append(nc)
    if cache is not None:
        return x, aux, cache
    if not made:
        return x, aux, None
    return x, aux, _stack_trees(made)


def _stack_trees(trees: list[dict]) -> dict:
    return {k: (_stack_trees([t[k] for t in trees])
                if isinstance(v, dict) else torch.stack([t[k] for t in trees]))
            for k, v in trees[0].items()}


def _embed(params, tokens, cfg: ArchConfig, plan: ShardingPlan):
    """The embeddings of ``tokens``: this rank's block of the sequence
    under ``split_sequence``."""
    w = _whole(params, "embed", cfg, plan)
    split = _vocab_split(cfg, plan) > 1
    if split:
        # this rank's vocabulary rows, zero for the others' tokens, summed
        v0 = tp_rank() * w.shape[0]
        mine = (tokens >= v0) & (tokens < v0 + w.shape[0])
        rows = w[torch.where(mine, tokens - v0, 0)]
        x = leave_region(torch.where(mine[..., None], rows, 0), True)
    else:
        x = leave_region(w[tokens], False)
    if cfg.scale_embed:  # gemma convention
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x.to(DTYPES[cfg.compute_dtype])


def _unembed(params, x, cfg: ArchConfig, plan: ShardingPlan):
    """The logits of ``x``, whole (gathered over a split vocabulary)."""
    w = _unembedding(params, cfg, plan)
    split = _vocab_split(cfg, plan) > 1
    if split:
        x = copy_to_model(x)
    logits = torch.einsum("bsd,dv->bsv", x.float(), w.float())
    if split:
        logits = gather_model(logits, 2)
    return constrain(logits, plan, ("batch", None, "tp"))


def _unembedding(params, cfg: ArchConfig, plan: ShardingPlan):
    """The (d, V) unembedding: the embedding's transpose when tied (this
    rank's V block where ``model`` splits the vocabulary)."""
    if cfg.tie_embeddings:
        return _whole(params, "embed", cfg, plan).T
    return _whole(params, "lm_head", cfg, plan)


def _encoder(params, batch, cfg, plan):
    """The encoder's output, whole: its stack runs in train mode in every
    mode, so under ``cfg.seq_parallel_acts`` its residual is split along
    the sequence (``_seq_split``) and gathered at the end."""
    x = batch["enc_embeds"].to(DTYPES[cfg.compute_dtype])
    enc_pos = torch.arange(x.shape[1], device=x.device)
    x = x + sinusoidal_from_pos(enc_pos, cfg.d_model).to(x.dtype)
    with split_sequence(_seq_split(cfg, plan, x.shape[1], "train")):
        x = leave_region(x, False)
        for r, (spec, L) in enumerate(encoder_runs(cfg)):
            x, _, _ = _run_stack(spec, params[f"enc_run{r}"], x,
                                 enc_pos[None], cfg, plan, mode="train",
                                 cache=None)
        x = _apply_norm(_whole(params, "enc_final_norm", cfg, plan), x, cfg)
        return enter_region(x, False)


def backbone(params, tokens, pos, cfg, plan, *, mode, cache=None,
             pos3=None, batch=None, seq=()):
    """Shared trunk. Returns (hidden, aux, new_cache).  ``seq``: the mesh
    axes that split the attention caches' slots (``cache_seq``).  Under
    ``split_sequence`` (``loss_fn``) the hidden states are this rank's
    block of the sequence."""
    x = _embed(params, tokens, cfg, plan)
    s0, n = sequence_start(x.shape[1]), x.shape[1]
    if cfg.n_patches and batch is not None and "patch_embeds" in batch:
        pe = batch["patch_embeds"].to(x.dtype)[:, s0:s0 + n]
        x = torch.cat([pe, x[:, pe.shape[1]:]], dim=1)
    if cfg.enc_dec:  # whisper decoder: absolute positions, any mode
        x = x + sinusoidal_from_pos(pos[..., s0:s0 + n], cfg.d_model).to(
            x.dtype)
    x = constrain(x, plan, ("batch", None, None))
    x_enc = _encoder(params, batch, cfg, plan) \
        if cfg.enc_dec and mode in ("train", "prefill") else None

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_cache = {}
    cache_pos = cache["pos"] if cache is not None else None
    for r, (spec, L) in enumerate(layer_runs(cfg)):
        c = cache.get(f"run{r}") if cache is not None else None
        x, a, nc = _run_stack(spec, params[f"run{r}"], x, pos, cfg, plan,
                              mode=mode, cache=c, cache_pos=cache_pos,
                              pos3=pos3, x_enc=x_enc, seq=seq)
        aux = aux + a
        if nc is not None:
            new_cache[f"run{r}"] = nc
    x = _apply_norm(_whole(params, "final_norm", cfg, plan), x, cfg)
    if mode != "train":
        step = 1 if mode == "decode" else tokens.shape[1]
        new_cache["pos"] = (cache_pos + step if cache_pos is not None else
                            torch.tensor(step, dtype=torch.int32,
                                         device=x.device))
    return x, aux, new_cache


# --------------------------------------------------------------------------
# Entry points


def _xent_sums(xc, w, lc):
    """One chunk's (Σ nll, Σ lse²) from its float32 logits."""
    logits = torch.einsum("bsd,dv->bsv", xc.float(), w.float())
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lc[..., None].long())[..., 0]
    return (lse - gold).sum(), (lse ** 2).sum()


def _xent_sums_split(xc, w, lc):
    """``_xent_sums`` of this rank's vocabulary block (columns from
    ``tp_rank() * Vl``): the log-sum-exp from the max over ``model`` and
    the sum of the ranks' sums of exp, the gold logit from the rank that
    holds it."""
    logits = torch.einsum("bsd,dv->bsv", xc.float(), w.float())
    mx = max_over_model(logits.amax(-1))
    lse = mx + torch.log(reduce_from_model(
        torch.exp(logits - mx[..., None]).sum(-1)))
    v0 = tp_rank() * logits.shape[-1]
    mine = (lc >= v0) & (lc < v0 + logits.shape[-1])
    gold = torch.gather(logits, -1, torch.where(mine, lc - v0, 0)[
        ..., None].long())[..., 0]
    gold = reduce_from_model(torch.where(mine, gold, 0.0))
    return (lse - gold).sum(), (lse ** 2).sum()


def _xent_chunked(x, w, labels, plan: ShardingPlan, chunk: int = 512,
                  split: bool = False):
    """Sequence-chunked softmax xent: never keeps (B,S,V) logits alive.

    Each chunk's (B,c,V) float32 logits are recomputed in the backward
    pass (``torch.utils.checkpoint``), bounding activation memory at
    (B,chunk,V/tp): with ``split``, ``w`` is this rank's vocabulary block
    (``_xent_sums_split``).  Under ``split_sequence`` ``x`` is this rank's
    block of the sequence, gathered here: every ``model`` rank takes the
    same tokens.  Returns (Σ nll, Σ lse²), each over B·S."""
    x = enter_region(x, split)
    B, S, d = x.shape
    c = min(chunk, S)
    n = S // c
    assert S % c == 0
    sums = in_this_context(_xent_sums_split if split else _xent_sums)
    nll = torch.zeros((), dtype=torch.float32, device=x.device)
    z2 = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n):
        a, b = checkpoint(sums, x[:, i * c:(i + 1) * c], w,
                          labels[:, i * c:(i + 1) * c], use_reentrant=False)
        nll, z2 = nll + a, z2 + b
    denom = B * S
    return nll / denom, z2 / denom


def loss_fn(params, batch, cfg: ArchConfig, plan: ShardingPlan):
    """Causal-LM cross entropy (+ MoE aux). batch: tokens, labels [+stubs].
    Returns (loss, {"nll", "aux", "zloss"}), 0-d float32 tensors."""
    tokens = batch["tokens"]
    pos = batch.get("pos")
    if pos is None:
        pos = torch.arange(tokens.shape[1], device=tokens.device)[None]
    with split_sequence(_seq_split(cfg, plan, tokens.shape[1], "train")):
        x, aux, _ = backbone(params, tokens, pos, cfg, plan, mode="train",
                             pos3=batch.get("pos3"), batch=batch)
        w = _unembedding(params, cfg, plan)
        nll, z2 = _xent_chunked(x, w, batch["labels"], plan,
                                split=_vocab_split(cfg, plan) > 1)
    z = 1e-4 * z2
    loss = nll + z + 1e-2 * aux
    return loss, {"nll": nll, "aux": aux, "zloss": z}


def prefill(params, batch, cfg: ArchConfig, plan: ShardingPlan,
            cache_len: int, global_batch: int | None = None):
    """Build decode caches from a full prompt; returns (cache, last logits).
    On a mesh, ``batch`` holds this rank's rows of a batch of
    ``global_batch`` (default ``batch_size``) and the cache is this rank's
    block of the whole."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    if S > cache_len:
        raise ValueError(f"prompt of {S} tokens is longer than the cache "
                         f"capacity {cache_len}")
    Bg = batch_size(B, plan, global_batch)
    cache = init_cache(cfg, Bg, cache_len, tokens.device, plan)
    pos = batch.get("pos", torch.arange(S, device=tokens.device)[None])
    x, _, new_cache = backbone(params, tokens, pos, cfg, plan, mode="prefill",
                               cache=cache, pos3=batch.get("pos3"),
                               batch=batch,
                               seq=cache_seq(cfg, plan, Bg, cache_len))
    logits = _unembed(params, x[:, -1:], cfg, plan)
    return new_cache, logits


def decode_step(params, cache, tokens, cfg: ArchConfig, plan: ShardingPlan,
                batch=None, global_batch: int | None = None,
                cache_len: int | None = None):
    """One token for every sequence in the batch. tokens (B, 1).  The
    cache's tensors are updated in place; the returned cache holds them
    and the advanced ``pos``.  On a mesh, ``global_batch`` and
    ``cache_len`` are those ``prefill`` was given (``cache_len`` is
    needed where the plan may split the cache's slots)."""
    pos = cache["pos"] + torch.zeros(tokens.shape, dtype=torch.int32,
                                     device=tokens.device)
    pos3 = pos.expand((3,) + tuple(tokens.shape)) if cfg.m_rope else None
    Bg = batch_size(tokens.shape[0], plan, global_batch)
    x, _, new_cache = backbone(params, tokens, pos, cfg, plan, mode="decode",
                               cache=cache, pos3=pos3, batch=batch,
                               seq=cache_seq(cfg, plan, Bg, cache_len))
    logits = _unembed(params, x, cfg, plan)
    return new_cache, logits
