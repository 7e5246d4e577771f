"""Attention: blockwise (flash-style) SDPA, GQA/MQA, qk-norm, MLA, caches
(the port of ``repro.models.attention``).

The blockwise attention is the reference's algorithm in plain PyTorch: a
loop over query blocks and, inside it, over KV blocks, with the online
softmax's ``m`` / ``l`` / ``acc`` in float32 (the reference's
``preferred_element_type=float32``), so long prompts never materialize S×S
scores.  No Pallas kernel lies behind it in the reference (XLA runs its
``lax.scan``), so the port has no hand-written kernel here either.

Decode uses a ring-buffer KV cache: capacity = the cache's length, slot
``pos % S`` overwritten, full-window attention over ``min(pos + 1, S)``
slots.  The cache's tensors are updated in place.  MLA decode runs in
*absorbed* form — scores and values are computed against the
(kv_lora+rope) latent cache without materializing per-head K/V.

Where the reference asks for float32 results of bf16 operands
(``preferred_element_type``), the port upcasts the operands first: the
products of bf16 values are exact in float32, so both accumulate the same
terms in float32.

Where the plan splits a cache's slots (``seq``: a batch too small for
``data``, the reference's ``("batch", "seq", ...)`` cache spec), a rank
holds slots ``[s0, s0 + S/n)`` of the ring buffer.  Prefill writes the
prompt's positions that fall in that range; in decode the rank that owns
slot ``pos % S`` writes the new K / V (MLA: ``c_kv``, ``k_rope``) and the
others write nothing; each rank attends to its valid slots and keeps its
partial ``(o, m, l)`` in float32, and the ranks merge them by a max and a
sum over ``seq`` (flash decoding's log-sum-exp merge).  A rank with no
valid slot contributes ``m = -inf``, ``l = 0``.

On a mesh whose ``model`` axis splits the query heads (the reference's
pin of ``q`` at ``("batch", None, "tp", None)``: ``parallel.shard.
tp_ranks``), a rank runs its H/m query heads with the KV heads they use,
on its columns of ``wq`` / ``wk`` / ``wv`` (MLA: ``wq_b`` / ``wkv_b``,
after the replicated latents) and its rows of ``wo``, whose partial
products ``reduce_from_model`` sums.  ``*_split`` say how such a block
gathers its leaves.  The caches keep every KV head on every rank (the
plan's ``("batch", "seq", None, None)``): a rank's new K / V heads are
all-gathered over ``model`` before they are written, so the copies stay
equal.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import NO_SHARDING, ArchConfig, ShardingPlan
from repro_torch.parallel.shard import (copy_to_model, enter_region,
                                        gather_model, leave_region, max_over,
                                        seq_block, sum_over, tp_rank,
                                        tp_ranks)
from .layers import (ParamDef, apply_m_rope, apply_rope, constrain, f32,
                     rms_norm)

NEG_INF = -1e30


def _pick(S: int, target: int) -> int:
    """Largest block <= target that divides S."""
    for b in range(min(target, S), 0, -1):
        if S % b == 0:
            return b
    return S


def _blockwise(q, k, v, *, causal: bool, scale: float, q_block: int = 512,
               kv_block: int = 512):
    """q (B,Sq,H,D), k/v (B,Sk,Hkv,Dk/Dv) -> (B,Sq,H,Dv); online softmax.

    Causal: a KV block after every query of the query block is skipped
    and only a block across the diagonal is masked.  Both are exact: the
    first KV block gives every row a finite max, so a masked block's
    probabilities underflow to 0 and its rescale factor is 1, and an
    all-true mask leaves the scores as they are."""
    B, Sq, H, D = q.shape
    Sk, Hkv, Dv = k.shape[1], k.shape[2], v.shape[3]
    G = H // Hkv
    bq, bk = _pick(Sq, q_block), _pick(Sk, kv_block)
    nq, nk = Sq // bq, Sk // bk
    dev = q.device

    qb = f32(q).reshape(B, nq, bq, Hkv, G, D)
    # each block pair's two batched matmuls, as ``torch.einsum`` lays them
    # out ((B·Hkv, G·bq, D) @ (B·Hkv, D, bk), then @ (B·Hkv, bk, Dv)), with
    # the key and value blocks laid out once rather than copied per pair
    kt = f32(k).reshape(B, nk, bk, Hkv, D).permute(1, 0, 3, 4, 2).reshape(
        nk, B * Hkv, D, bk)
    vt = v.reshape(B, nk, bk, Hkv, Dv).permute(1, 0, 3, 2, 4).reshape(
        nk, B * Hkv, bk, Dv)
    outs = []
    for qi in range(nq):
        qt = qb[:, qi].permute(0, 2, 3, 1, 4).reshape(B * Hkv, G * bq, D)
        qpos = qi * bq + torch.arange(bq, device=dev)
        m = torch.full((B, Hkv, G, bq), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, Hkv, G, bq), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, Hkv, G, bq, Dv), dtype=torch.float32,
                          device=dev)
        for ki in range(nk):
            if causal and ki * bk > qi * bq + bq - 1:
                break    # every later key is after every query of the block
            s = torch.bmm(qt, kt[ki]).view(B, Hkv, G, bq, bk) * scale
            if causal and ki * bk + bk - 1 > qi * bq:   # the diagonal
                kpos = ki * bk + torch.arange(bk, device=dev)
                mask = qpos[:, None] >= kpos[None, :]
                s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            pv = torch.bmm(f32(p.to(v.dtype)).view(B * Hkv, G * bq, bk),
                           f32(vt[ki])).view(B, Hkv, G, bq, Dv)
            acc = acc * alpha[..., None] + pv
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]  # (B,Hkv,G,bq,Dv)
        outs.append(out.permute(0, 3, 1, 2, 4).to(q.dtype))
    # (B, bq, Hkv, G, Dv) per block -> (B, Sq, H, Dv)
    return torch.cat(outs, dim=1).reshape(B, Sq, H, Dv)


def _valid_mask(S: int, n_valid, device, s0: int = 0):
    """(S,) True for the filled cache slots among ``s0 .. s0 + S - 1``
    (``n_valid`` a 0-d tensor: the filled slots are ``0 .. n_valid - 1``)."""
    return torch.arange(s0, s0 + S, device=device) < n_valid


def _n_valid(cache_pos, S: int):
    """The filled slots of a ring buffer of ``S`` after writing slot
    ``cache_pos % S``."""
    return torch.clamp(cache_pos + 1, max=S)


def _merge_split(s, valid, values, seq):
    """Softmax-weighted values over slots split over the mesh axes
    ``seq``: ``s`` (..., Sl) float32 scores of this rank's slots, ``valid``
    (Sl,) its filled ones, ``values(e)`` the product of weights ``e``
    (..., Sl) with its values (..., Dv).  The rank's partial ``(o, m, l)``
    (m = -inf, l = 0 where no slot is valid) are merged by a max and a
    sum over ``seq``."""
    s = torch.where(valid, s, float("-inf"))
    m = s.amax(-1, keepdim=True)
    e = torch.where(valid, torch.exp(s - torch.where(torch.isfinite(m), m,
                                                     0.0)), 0.0)
    o, l = values(e), e.sum(-1, keepdim=True)
    a = torch.exp(m - max_over(m, seq))           # 0 where m = -inf
    tot = sum_over(torch.cat([o * a, l * a], dim=-1), seq)
    return tot[..., :-1] / tot[..., -1:]


def _decode_sdpa(q, k, v, scale: float, n_valid=None, seq=(), s0: int = 0):
    """q (B,1,H,D) vs cache k/v (B,S,Hkv,D*) -> (B,1,H,Dv).

    `n_valid`: number of filled cache slots (unfilled ones are masked);
    ``seq``: the mesh axes that split the slots (this rank's from
    ``s0``)."""
    B, _, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    qh = q.reshape(B, Hkv, G, D)
    s = torch.einsum("bhgd,bkhd->bhgk", f32(qh), f32(k)) * scale
    if seq:
        o = _merge_split(s, _valid_mask(S, n_valid, s.device, s0),
                         lambda e: torch.einsum("bhgk,bkhd->bhgd",
                                                f32(e.to(v.dtype)), f32(v)),
                         seq)
        return o.reshape(B, 1, H, v.shape[3]).to(q.dtype)
    if n_valid is not None:
        s = torch.where(_valid_mask(S, n_valid, s.device), s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", f32(p.to(v.dtype)), f32(v))
    return o.reshape(B, 1, H, v.shape[3]).to(q.dtype)


def _write_slot(buf, x, cache_pos, seq=()):
    """Overwrite slot ``cache_pos % S`` of the ring buffer ``buf`` with
    ``x`` (B, 1, ...) in place (``cache_pos`` a 0-d device tensor: no host
    read).  With ``seq``, ``buf`` is this rank's block of the slots: the
    rank that holds the slot writes it, the others leave ``buf`` as it
    is."""
    S, s0 = seq_block(seq, buf.shape[1])
    slot = (cache_pos % S).reshape(()).to(torch.long)
    x = x.to(buf.dtype)
    if seq:
        local = slot - s0
        mine = (local >= 0) & (local < buf.shape[1])
        slot = torch.clamp(local, 0, buf.shape[1] - 1)
        x = torch.where(mine, x, buf.index_select(1, slot.reshape(1)))
    buf.index_copy_(1, slot.reshape(1), x)
    return buf


def _write_prefix(buf, x, seq=()):
    """Overwrite the first ``x.shape[1]`` slots with the prompt's ``x``
    (B, S, ...) in place: of this rank's block of the slots with
    ``seq``."""
    _, s0 = seq_block(seq, buf.shape[1])
    n = min(buf.shape[1], x.shape[1] - s0)
    if n > 0:
        buf[:, :n].copy_(x[:, s0:s0 + n])
    return buf


# --------------------------------------------------------------------------
# GQA / MQA (+ qk-norm, RoPE / M-RoPE)


def gqa_defs(cfg: ArchConfig, dt: str) -> dict:
    d, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    defs = {
        "wq": ParamDef((d, H * hd), ("fsdp", "tp"), dtype=dt),
        "wk": ParamDef((d, Hkv * hd), ("fsdp", "tp"), dtype=dt),
        "wv": ParamDef((d, Hkv * hd), ("fsdp", "tp"), dtype=dt),
        "wo": ParamDef((H * hd, d), ("tp", "fsdp"), dtype=dt),
    }
    if cfg.qk_norm:
        defs["q_norm"] = ParamDef((hd,), (None,), init="ones", dtype=dt)
        defs["k_norm"] = ParamDef((hd,), (None,), init="ones", dtype=dt)
    return defs


def _kv_keep(n_kv: int, m: int) -> tuple[int, bool]:
    """``(keep, summed)`` of ``wk`` / ``wv`` when ``m`` ranks split the
    query heads: each rank's own KV heads, or, where ``m`` exceeds the KV
    heads, the columns of the one KV head that ``m // n_kv`` consecutive
    ranks share, gathered among them, its gradient summed over them."""
    if n_kv % m == 0:
        return 1, False
    if m % n_kv == 0:
        return m // n_kv, True
    raise NotImplementedError(f"{n_kv} KV heads over {m} model ranks: a "
                              "rank's query heads would span a KV head "
                              "boundary")


def gqa_split(cfg: ArchConfig, plan: ShardingPlan) -> dict:
    """``gather_tree``'s split of a GQA block's leaves ({} when the block
    runs whole on every rank)."""
    m = tp_ranks(plan, "tp", cfg.n_heads)
    if m == 1:
        return {}
    kv = _kv_keep(cfg.n_kv_heads, m)
    return {"wq": (1, False), "wo": (1, False), "wk": kv, "wv": kv}


def _heads(cfg: ArchConfig, m: int) -> tuple[int, int, int]:
    """This rank's query heads' count, and its first KV head and their
    count, under ``m`` ranks of ``model``."""
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    Hq, G = H // m, H // Hkv
    _kv_keep(Hkv, m)            # raises where the heads do not nest
    return Hq, tp_rank() * Hq // G, max(Hq // G, 1)


def _kv_cols(w, kv0: int, n: int, hd: int):
    """The ``wk`` / ``wv`` columns of this rank's ``n`` KV heads from
    ``kv0``: ``w`` itself when it holds just these (its gathered block),
    narrowed when it holds every KV head (``model`` replicates it)."""
    return w if w.shape[-1] == n * hd else w.narrow(-1, kv0 * hd, n * hd)


def _kv_heads(t, kv0: int, n: int):
    """This rank's ``n`` KV heads from ``kv0`` of a (B, S, heads, D) K or V
    that holds them or every KV head (a cache)."""
    return t if t.shape[2] == n else t.narrow(2, kv0, n)


def kv_whole(t, cfg: ArchConfig, plan: ShardingPlan):
    """(B, S, Hkv, D) of a rank's KV heads (B, S, n, D): all-gathered over
    ``model`` (every ``keep``-th block where ``keep`` ranks share a KV
    head) where ``model`` splits the heads; ``t`` itself where it does
    not."""
    m = tp_ranks(plan, "tp", cfg.n_heads)
    if m == 1:
        return t
    keep, _ = _kv_keep(cfg.n_kv_heads, m)
    g = gather_model(t, 2)
    return g[:, :, ::keep] if keep > 1 else g


def gqa_apply(p, x, pos, cfg: ArchConfig, plan: ShardingPlan, *,
              causal=True, mode="train", cache=None, cache_pos=None,
              pos3=None, seq=()):
    """mode: train/prefill (blockwise) | decode (ring-buffer cache);
    ``seq``: the mesh axes that split the cache's slots."""
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    wk, wv = p["wk"], p["wv"]
    q_norm, k_norm = p.get("q_norm"), p.get("k_norm")
    m = tp_ranks(plan, "tp", H)
    x = enter_region(x, m > 1)
    B, S, d = x.shape
    kv0 = 0
    if m > 1:        # this rank's heads; replicated inputs enter the split
        H, kv0, Hkv = _heads(cfg, m)
        wk, wv = _kv_cols(wk, kv0, Hkv, hd), _kv_cols(wv, kv0, Hkv, hd)
        if cfg.qk_norm:      # applied to this rank's heads only
            q_norm, k_norm = copy_to_model(q_norm), copy_to_model(k_norm)
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    k = (x @ wk).reshape(B, S, Hkv, hd)
    v = (x @ wv).reshape(B, S, Hkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, q_norm, cfg.rms_eps)
        k = rms_norm(k, k_norm, cfg.rms_eps)
    if cfg.m_rope and pos3 is not None:
        sections = _mrope_sections(hd)
        q = apply_m_rope(q, pos3, sections, cfg.rope_theta)
        k = apply_m_rope(k, pos3, sections, cfg.rope_theta)
    elif cfg.rope_theta > 0:  # whisper (theta=0) uses absolute positions
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    q = constrain(q, plan, ("batch", None, "tp", None))
    scale = hd ** -0.5

    if mode == "decode":
        S_cache, s0 = seq_block(seq, cache["k"].shape[1])
        k_cache = _write_slot(cache["k"], kv_whole(k, cfg, plan), cache_pos,
                              seq)
        v_cache = _write_slot(cache["v"], kv_whole(v, cfg, plan), cache_pos,
                              seq)
        o = _decode_sdpa(q, _kv_heads(k_cache, kv0, Hkv),
                         _kv_heads(v_cache, kv0, Hkv), scale,
                         _n_valid(cache_pos, S_cache), seq, s0)
        new_cache = {"k": k_cache, "v": v_cache}
    else:
        o = _blockwise(q, k, v, causal=causal, scale=scale)
        new_cache = None
        if mode == "prefill":
            k, v = kv_whole(k, cfg, plan), kv_whole(v, cfg, plan)
            if cache is not None:  # write prompt K/V into the cache buffer
                new_cache = {"k": _write_prefix(cache["k"], k, seq),
                             "v": _write_prefix(cache["v"], v, seq)}
            else:
                new_cache = {"k": k.to(torch.bfloat16),
                             "v": v.to(torch.bfloat16)}
    out = leave_region(o.reshape(B, S, H * hd) @ p["wo"], m > 1)
    return constrain(out, plan, ("batch", None, "fsdp")), new_cache


def gqa_cross_apply(p, x, enc_kv, cfg: ArchConfig, plan: ShardingPlan):
    """Cross-attention against precomputed encoder K/V (whisper decoder):
    ``enc_kv`` holds this rank's KV heads (``encode_kv``) or every KV head
    (the cache)."""
    H, hd = cfg.n_heads, cfg.head_dim_
    k, v = enc_kv["k"], enc_kv["v"]
    m = tp_ranks(plan, "tp", H)
    x = enter_region(x, m > 1)
    B, S, d = x.shape
    if m > 1:
        H, kv0, n = _heads(cfg, m)
        k, v = _kv_heads(k, kv0, n), _kv_heads(v, kv0, n)
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    o = _blockwise(q, k, v, causal=False, scale=hd ** -0.5)
    out = leave_region(o.reshape(B, S, H * hd) @ p["wo"], m > 1)
    return constrain(out, plan, ("batch", None, "fsdp"))


def encode_kv(p, x_enc, cfg: ArchConfig, plan: ShardingPlan = NO_SHARDING):
    """The encoder's K/V of this rank's KV heads (every KV head unless
    ``model`` splits the heads); ``x_enc`` is the whole encoder output,
    also under a sequence split."""
    B, S, _ = x_enc.shape
    Hkv, hd = cfg.n_kv_heads, cfg.head_dim_
    wk, wv = p["wk"], p["wv"]
    m = tp_ranks(plan, "tp", cfg.n_heads)
    if m > 1:
        _, kv0, Hkv = _heads(cfg, m)
        x_enc = copy_to_model(x_enc)
        wk, wv = _kv_cols(wk, kv0, Hkv, hd), _kv_cols(wv, kv0, Hkv, hd)
    return {"k": (x_enc @ wk).reshape(B, S, Hkv, hd),
            "v": (x_enc @ wv).reshape(B, S, Hkv, hd)}


def _mrope_sections(head_dim: int) -> tuple[int, int, int]:
    """Qwen2-VL splits D/2 rotary channels among (t, h, w) as 2:3:3."""
    half = head_dim // 2
    t = half // 4
    h = (half - t) // 2
    return (t, h, half - t - h)


# --------------------------------------------------------------------------
# MLA (deepseek-v3 / minicpm3)


def mla_defs(cfg: ArchConfig, dt: str) -> dict:
    d, H = cfg.d_model, cfg.n_heads
    ql, kvl = cfg.q_lora_rank, cfg.kv_lora_rank
    nope, rope, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    defs = {
        "wkv_a": ParamDef((d, kvl + rope), ("fsdp", None), dtype=dt),
        "kv_norm": ParamDef((kvl,), (None,), init="ones", dtype=dt),
        "wkv_b": ParamDef((kvl, H * (nope + vd)), ("fsdp", "tp"), dtype=dt),
        "wo": ParamDef((H * vd, d), ("tp", "fsdp"), dtype=dt),
    }
    if ql > 0:
        defs["wq_a"] = ParamDef((d, ql), ("fsdp", None), dtype=dt)
        defs["q_norm"] = ParamDef((ql,), (None,), init="ones", dtype=dt)
        defs["wq_b"] = ParamDef((ql, H * (nope + rope)), ("fsdp", "tp"),
                                dtype=dt)
    else:
        defs["wq"] = ParamDef((d, H * (nope + rope)), ("fsdp", "tp"), dtype=dt)
    return defs


def mla_split(cfg: ArchConfig, plan: ShardingPlan) -> dict:
    """``gather_tree``'s split of an MLA block's leaves: the head-split
    ones (the latents ``wq_a``, ``wkv_a`` and their norms run whole)."""
    if tp_ranks(plan, "tp", cfg.n_heads) == 1:
        return {}
    own = (1, False)
    return {"wkv_b": own, "wo": own,
            ("wq_b" if cfg.q_lora_rank > 0 else "wq"): own}


def _mla_q(p, x, xw, cfg: ArchConfig, split: bool):
    """The queries of this rank's heads from the residual's ``x`` and its
    whole sequence ``xw`` (``x`` itself without a sequence split)."""
    B, S, _ = xw.shape
    nope, rope = cfg.qk_nope_dim, cfg.qk_rope_dim
    if cfg.q_lora_rank > 0:
        c_q = rms_norm(xw @ p["wq_a"], p["q_norm"], cfg.rms_eps)
        q = (copy_to_model(c_q) if split else c_q) @ p["wq_b"]
    else:
        q = (enter_region(x, True) if split else xw) @ p["wq"]
    q = q.reshape(B, S, -1, nope + rope)      # this rank's heads
    return q[..., :nope], q[..., nope:]


def mla_apply(p, x, pos, cfg: ArchConfig, plan: ShardingPlan, *,
              mode="train", cache=None, cache_pos=None, seq=()):
    m = tp_ranks(plan, "tp", cfg.n_heads)
    H = cfg.n_heads // m
    nope, rope, vd, kvl = (cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim,
                           cfg.kv_lora_rank)
    scale = (nope + rope) ** -0.5
    xw = enter_region(x, False)     # the latents run whole on every rank
    B, S, _ = xw.shape

    q_nope, q_rope = _mla_q(p, x, xw, cfg, m > 1)
    q_rope = apply_rope(q_rope, pos, cfg.rope_theta)

    kv_a = xw @ p["wkv_a"]                                # (B,S,kvl+rope)
    c_kv = rms_norm(kv_a[..., :kvl], p["kv_norm"], cfg.rms_eps)
    k_rope = apply_rope(kv_a[..., kvl:][:, :, None, :], pos,
                        cfg.rope_theta)                   # (B,S,1,rope)
    # the replicated latents enter the head split (the caches keep them)
    c_in, r_in = ((copy_to_model(c_kv), copy_to_model(k_rope)) if m > 1
                  else (c_kv, k_rope))

    wkv_b = p["wkv_b"].reshape(kvl, H, nope + vd)
    w_k, w_v = wkv_b[..., :nope], wkv_b[..., nope:]

    if mode == "decode":
        S_cache, s0 = seq_block(seq, cache["c_kv"].shape[1])
        c_cache = _write_slot(cache["c_kv"], c_kv, cache_pos, seq)
        r_cache = _write_slot(cache["k_rope"], k_rope[:, :, 0], cache_pos,
                              seq)
        # absorbed scores: q_nope' = q_nope @ w_k^T  -> (B,1,H,kvl)
        q_abs = torch.einsum("bshn,khn->bshk", q_nope, w_k)
        s = (torch.einsum("bshk,btk->bhst", f32(q_abs), f32(c_cache))
             + torch.einsum("bshr,btr->bhst", f32(q_rope), f32(r_cache))
             ) * scale
        n_valid = _n_valid(cache_pos, S_cache)
        if seq:
            o_lat = _merge_split(
                s, _valid_mask(c_cache.shape[1], n_valid, s.device, s0),
                lambda e: torch.einsum("bhst,btk->bhsk",
                                       f32(e.to(c_cache.dtype)),
                                       f32(c_cache)), seq).transpose(1, 2)
        else:
            s = torch.where(_valid_mask(S_cache, n_valid, s.device), s,
                            NEG_INF)
            pr = torch.softmax(s, dim=-1)
            o_lat = torch.einsum("bhst,btk->bshk",
                                 f32(pr.to(c_cache.dtype)), f32(c_cache))
        o = torch.einsum("bshk,khv->bshv", o_lat.to(x.dtype), w_v)
        new_cache = {"c_kv": c_cache, "k_rope": r_cache}
    else:
        # materialized K/V + blockwise attention
        k_nope = torch.einsum("btk,khn->bthn", c_in, w_k)
        v = torch.einsum("btk,khv->bthv", c_in, w_v)
        k = torch.cat([k_nope, r_in.expand(B, S, H, rope)], dim=-1)
        q = torch.cat([q_nope, q_rope], dim=-1)
        q = constrain(q, plan, ("batch", None, "tp", None))
        o = _blockwise(q, k, v, causal=True, scale=scale)
        new_cache = None
        if mode == "prefill":
            if cache is not None:
                new_cache = {"c_kv": _write_prefix(cache["c_kv"], c_kv, seq),
                             "k_rope": _write_prefix(cache["k_rope"],
                                                     k_rope[:, :, 0], seq)}
            else:
                new_cache = {"c_kv": c_kv.to(torch.bfloat16),
                             "k_rope": k_rope[:, :, 0].to(torch.bfloat16)}
    out = leave_region(o.reshape(B, S, H * vd) @ p["wo"], m > 1)
    return constrain(out, plan, ("batch", None, "fsdp")), new_cache
