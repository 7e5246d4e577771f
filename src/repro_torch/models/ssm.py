"""Attention-free sequence mixers: RWKV6 ("Finch") and Mamba (for Jamba) —
the port of ``repro.models.ssm``.

RWKV6 time-mix uses data-dependent per-channel decays, in the *chunked*
parallel form (GLA-style): within a chunk of length C the decays are
handled with cumulative log-decay matrices (f32), across chunks a recurrent
state (B, H, dk, dv) is carried by a loop over S/C steps (the reference's
``lax.scan``).  A step form (``rwkv6_step``) serves decode with O(1) state.

Mamba is the classic selective SSM: causal depthwise conv + input-dependent
(dt, B, C) and a diagonal state recurrence, run as a log-depth scan
inside chunks whose length a byte budget sets (``mamba_scan``: its own
backward recomputes each chunk from its entry state, so no (B, S, di, ds)
tensor is ever whole); decode keeps (conv window, h) as cache and runs one
step.  States and the decay's clips are float32, as in the reference.

On a mesh whose ``model`` axis splits the dim that the reference's plan
splits in these blocks' states (RWKV-6's heads, Mamba's ``di``:
``parallel.shard.tp_ranks``), a rank runs its own block of that dim, and
its cache leaves hold just that block, as the plan stores them:

- RWKV-6 time mix: ``r``, ``k``, ``v``, ``g`` and the decay on the rank's
  columns of ``w_r`` / ``w_k`` / ``w_v`` / ``w_g`` / ``decay_b`` (its H/m
  heads of 64 channels), the recurrence on those heads, ``ln_x``'s sum of
  squares over all ``d`` channels summed across ranks both ways
  (``sum_over_model``), its rows of ``w_o`` and a ``reduce_from_model``;
- RWKV channel mix: its columns of ``w_k`` and ``w_r``, its rows of
  ``w_v``;
- Mamba: its ``di/m`` channels through the conv, the ``dt`` and B/C
  projections (their partial products summed both ways over ``model``),
  the scan and its rows of ``w_out``.

The block's input enters through ``copy_to_model``; the leaves that
``model`` replicates but that the rank uses only in part (the token-shift
``mix``, the decay's LoRA and ``w0``, ``bonus_u``, ``ln_x``) and Mamba's
``w_in`` are gathered whole with a summed gradient (``*_split``).  Where
the plan does not split that dim (too few heads), the block runs whole on
every rank, its weights gathered over ``model``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, ShardingPlan
from repro_torch.parallel.shard import (enter_region, gather_from_model,
                                        leave_region, sum_over_model,
                                        tp_rank, tp_ranks)
from .layers import ParamDef, constrain, f32, rms_norm

OWN, SUMMED = (1, False), (None, True)     # gather_tree's split of a leaf


def _cols(t, m: int):
    """This rank's block of ``m`` along the last dim of ``t`` (``t``
    itself for ``m == 1``)."""
    if m == 1:
        return t
    n = t.shape[-1] // m
    return t.narrow(-1, tp_rank() * n, n)


def _norm_split(y, gamma, eps: float, d: int, m: int):
    """``rms_norm`` over all ``d`` channels of which ``y`` holds this
    rank's ``d/m`` (and ``gamma`` their scales): the sum of squares summed
    over ``model`` both ways."""
    if m == 1:
        return rms_norm(y, gamma, eps)
    dt = y.dtype
    y = f32(y)
    ss = sum_over_model(torch.sum(y * y, dim=-1, keepdim=True))
    y = y * torch.rsqrt(ss / d + eps)
    return (y * f32(gamma)).to(dt)

# --------------------------------------------------------------------------
# RWKV6


def rwkv6_defs(cfg: ArchConfig, dt: str) -> dict:
    d = cfg.d_model
    lora = max(32, d // 32)
    return {
        "w_r": ParamDef((d, d), ("fsdp", "tp"), dtype=dt),
        "w_k": ParamDef((d, d), ("fsdp", "tp"), dtype=dt),
        "w_v": ParamDef((d, d), ("fsdp", "tp"), dtype=dt),
        "w_g": ParamDef((d, d), ("fsdp", "tp"), dtype=dt),
        "w_o": ParamDef((d, d), ("tp", "fsdp"), dtype=dt),
        # data-dependent decay: w_t = exp(-exp(w0 + tanh(x W_a) W_b))
        "decay_w0": ParamDef((d,), (None,), init="zeros", dtype="float32"),
        "decay_a": ParamDef((d, lora), ("fsdp", None), dtype=dt),
        "decay_b": ParamDef((lora, d), (None, "fsdp"), dtype=dt),
        "bonus_u": ParamDef((d,), (None,), init="zeros", dtype="float32"),
        # token-shift mixing coefficients
        "mix": ParamDef((5, d), (None, None), init="zeros", dtype="float32"),
        "ln_x": ParamDef((d,), (None,), init="ones", dtype=dt),
    }


def rwkv6_heads(cfg: ArchConfig) -> int:
    return max(cfg.d_model // 64, 1)         # head_size 64 (RWKV convention)


def rwkv6_ranks(cfg: ArchConfig, plan: ShardingPlan) -> int:
    """The ``model`` ranks that split the time mix's heads (the state's
    ``("batch", "tp", None, None)``)."""
    return tp_ranks(plan, "tp", rwkv6_heads(cfg))


def rwkv6_split(cfg: ArchConfig, plan: ShardingPlan) -> dict:
    """``gather_tree``'s split of a time-mix block's leaves ({} when the
    block runs whole)."""
    if rwkv6_ranks(cfg, plan) == 1:
        return {}
    return {**{k: OWN for k in ("w_r", "w_k", "w_v", "w_g", "w_o")},
            **{k: SUMMED for k in ("decay_w0", "decay_a", "decay_b",
                                   "bonus_u", "mix", "ln_x")}}


def _rwkv6_inputs(p, x, x_prev, m: int = 1):
    """Token-shifted projections. x (B,S,d); x_prev (B,1,d) last token of
    previous segment (zeros at sequence start).  On ``m`` ranks the
    projections and the decay are this rank's channels (``w_*`` its
    column blocks, ``decay_w0`` / ``decay_b`` whole and cut here)."""
    xs = torch.cat([x_prev, x[:, :-1]], dim=1)            # shifted
    mix = torch.sigmoid(p["mix"]).to(x.dtype)             # (5, d)

    def mixed(i):
        return x + (xs - x) * mix[i]
    r = mixed(0) @ p["w_r"]
    k = mixed(1) @ p["w_k"]
    v = mixed(2) @ p["w_v"]
    g = F.silu(mixed(3) @ p["w_g"])
    lw = _cols(p["decay_w0"], m) + torch.tanh(
        mixed(4) @ p["decay_a"]) @ _cols(p["decay_b"], m)
    # log decay in [-5, 0): the lower clamp bounds the intra-chunk exponent
    # (chunk=16 -> |cum| <= 80 < log(f32 max)), exactly as chunked GLA does.
    log_w = -torch.clamp(torch.exp(torch.clamp(f32(lw), -10.0, 6.0)),
                         1e-6, 5.0)
    return r, k, v, g, log_w


def rwkv6_chunked(p, x, x_prev, state, cfg: ArchConfig,
                  plan: ShardingPlan, chunk: int = 16):
    """x (B,S,d) -> (y, (x_last, state)). state (B,H,dk,dv) f32 (this
    rank's H/m heads on a split)."""
    m = rwkv6_ranks(cfg, plan)
    x_in = enter_region(x, m > 1)
    B, S, d = x_in.shape
    dk = d // rwkv6_heads(cfg)
    H = rwkv6_heads(cfg) // m
    r, k, v, g, log_w = _rwkv6_inputs(p, x_in, x_prev, m)
    u = _cols(p["bonus_u"], m).reshape(H, dk)

    C = min(chunk, S)
    while S % C != 0:  # largest chunk <= requested that divides S
        C -= 1
    N = S // C

    def reshape_h(t):                                     # (B,S,d)->(N,B,H,C,dk)
        return f32(t).reshape(B, N, C, H, -1).permute(1, 0, 3, 2, 4)

    rs, ks, vs, lws = (reshape_h(r), reshape_h(k), reshape_h(v),
                       reshape_h(log_w))
    mask = torch.tril(torch.ones((C, C), dtype=torch.bool, device=x.device),
                      diagonal=-1)
    # every chunk's own terms at once; only the state runs chunk by chunk
    cum = torch.cumsum(lws, dim=3)                        # inclusive Σ log w
    total = cum[..., -1:, :]                              # (N,B,H,1,dk)
    # decay of state contribution up to each position (exclusive)
    r_dec = rs * torch.exp(cum - lws)                     # r_t Π_{s<t} w_s
    # intra-chunk: pairwise decays Π_{s<t..} via cum differences
    ki = ks * torch.exp(-cum)                             # k_s / Π_{u<=s} w
    att = torch.where(mask, torch.einsum("nbhck,nbhsk->nbhcs", r_dec, ki),
                      0.0)
    y_intra = torch.einsum("nbhcs,nbhsv->nbhcv", att, vs)
    # current-token bonus u
    y_diag = torch.einsum("nbhck,nbhck->nbhc", rs * u[:, None, :],
                          ks)[..., None] * vs
    # state update: S' = diag(Πw) S + Σ_s (Π_{u>s} w ⊙ k_s)^T v_s
    k_dec_v = torch.einsum("nbhsk,nbhsv->nbhkv", ks * torch.exp(total - cum),
                           vs)
    decay = torch.exp(total).transpose(3, 4)              # (N,B,H,dk,1)
    y_inter = []
    for n in range(N):
        # inter-chunk: r_t · (Π_{s<t} w) · state
        y_inter.append(torch.einsum("bhck,bhkv->bhcv", r_dec[n], state))
        state = decay[n] * state + k_dec_v[n]
    ys = torch.stack(y_inter) + y_intra + y_diag
    # (N,B,H,C,dv) -> (B,S,d)
    y = ys.permute(1, 0, 3, 2, 4).reshape(B, S, H * dk)
    y = _norm_split(y.to(x.dtype), _cols(p["ln_x"], m), cfg.rms_eps, d,
                    m) * g
    out = leave_region(y @ p["w_o"], m > 1)
    out = constrain(out, plan, ("batch", None, "fsdp"))
    return out, (x[:, -1:], state)


def rwkv6_step(p, x, x_prev, state, cfg: ArchConfig, plan: ShardingPlan):
    """Single-token decode. x (B,1,d); state (B,H,dk,dv) (H/m heads)."""
    B, _, d = x.shape
    m = rwkv6_ranks(cfg, plan)
    dk = d // rwkv6_heads(cfg)
    H = rwkv6_heads(cfg) // m
    x_in = enter_region(x, m > 1)
    r, k, v, g, log_w = _rwkv6_inputs(p, x_in, x_prev, m)
    u = _cols(p["bonus_u"], m).reshape(H, dk)
    rh = f32(r).reshape(B, H, dk)
    kh = f32(k).reshape(B, H, dk)
    vh = f32(v).reshape(B, H, dk)
    w = torch.exp(log_w.reshape(B, H, dk))
    kv = torch.einsum("bhk,bhv->bhkv", kh, vh)
    y = torch.einsum("bhk,bhkv->bhv", rh, state + u[None, :, :, None] * kv)
    state = w[..., None] * state + kv
    y = y.reshape(B, 1, H * dk).to(x.dtype)
    y = _norm_split(y, _cols(p["ln_x"], m), cfg.rms_eps, d, m) * g
    return leave_region(y @ p["w_o"], m > 1), (x, state)


def rwkv6_ffn_defs(cfg: ArchConfig, dt: str) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w_k": ParamDef((d, f), ("fsdp", "tp"), dtype=dt),
        "w_v": ParamDef((f, d), ("tp", "fsdp"), dtype=dt),
        "w_r": ParamDef((d, d), ("fsdp", "tp"), dtype=dt),
        "mix": ParamDef((2, d), (None, None), init="zeros", dtype="float32"),
    }


def rwkv6_ffn_ranks(cfg: ArchConfig, plan: ShardingPlan) -> int:
    """The ``model`` ranks that split the channel mix: its hidden columns
    and the receptance's, where the plan splits both ``d_ff`` and ``d``."""
    return min(tp_ranks(plan, "tp", cfg.d_ff), tp_ranks(plan, "tp",
                                                        cfg.d_model))


def rwkv6_ffn_split(cfg: ArchConfig, plan: ShardingPlan) -> dict:
    """``gather_tree``'s split of a channel-mix block's leaves."""
    if rwkv6_ffn_ranks(cfg, plan) == 1:
        return {}
    return {"w_k": OWN, "w_v": OWN, "w_r": OWN, "mix": SUMMED}


def rwkv6_ffn(p, x, x_prev, cfg: ArchConfig, plan: ShardingPlan):
    """RWKV channel-mix: relu² K, sigmoid receptance gate.

    Split over ``model``, a rank computes ``relu(xk @ w_k)²`` on its
    columns of ``w_k`` and its rows' partial product with ``w_v`` (summed
    by ``reduce_from_model``), and the receptance on its columns of
    ``w_r``, all-gathered over ``model`` (``gather_from_model``) before it
    gates the sum.  Gathering ``w_r`` whole instead would have every rank
    compute the whole (d, d) receptance: at ``rwkv6-1.6b``'s widths on 16
    ranks that is 2.3x the rest of the rank's channel mix.  Under a
    sequence split the token shift runs on the whole sequence, and the
    sum and the receptance leave the region as this rank's block of it."""
    m = rwkv6_ffn_ranks(cfg, plan)
    x_in = enter_region(x, m > 1)
    xs = torch.cat([x_prev, x_in[:, :-1]], dim=1)
    mix = torch.sigmoid(p["mix"]).to(x.dtype)
    xk = x_in + (xs - x_in) * mix[0]
    xr = x_in + (xs - x_in) * mix[1]
    kk = torch.square(torch.relu(xk @ p["w_k"]))
    kv = kk @ p["w_v"]
    rr = torch.sigmoid(xr @ p["w_r"])
    if m > 1:
        kv = leave_region(kv, True)
        out = leave_region(gather_from_model(rr, -1), False) * kv
    else:
        out = leave_region(rr * kv, False)
    return constrain(out, plan, ("batch", None, "fsdp")), x[:, -1:]


# --------------------------------------------------------------------------
# Mamba (selective SSM, for Jamba)


def mamba_defs(cfg: ArchConfig, dt: str) -> dict:
    d = cfg.d_model
    di = cfg.expand * d
    ds, dc = cfg.d_state, cfg.d_conv
    dt_rank = max(d // 16, 1)
    return {
        "w_in": ParamDef((d, 2 * di), ("fsdp", "tp"), dtype=dt),
        "conv_w": ParamDef((dc, di), (None, "tp"), scale=0.5, dtype=dt),
        "conv_b": ParamDef((di,), ("tp",), init="zeros", dtype=dt),
        "w_xdt": ParamDef((di, dt_rank), ("tp", None), dtype=dt),
        "w_dt": ParamDef((dt_rank, di), (None, "tp"), dtype=dt),
        "dt_bias": ParamDef((di,), ("tp",), init="zeros", dtype="float32"),
        "w_bc": ParamDef((di, 2 * ds), ("tp", None), dtype=dt),
        "log_a": ParamDef((di, ds), ("tp", None), init="zeros",
                          dtype="float32"),
        "d_skip": ParamDef((di,), ("tp",), init="ones", dtype="float32"),
        "w_out": ParamDef((di, d), ("tp", "fsdp"), dtype=dt),
    }


def mamba_ranks(cfg: ArchConfig, plan: ShardingPlan) -> int:
    """The ``model`` ranks that split Mamba's ``di`` channels (the
    caches' ``conv`` ``("batch", None, "tp")``, ``h`` ``("batch", "tp",
    None)``)."""
    return tp_ranks(plan, "tp", cfg.expand * cfg.d_model)


def mamba_split(cfg: ArchConfig, plan: ShardingPlan) -> dict:
    """``gather_tree``'s split of a Mamba block's leaves.  ``w_in``'s
    ``model`` blocks cut the concatenated ``[u | z]`` columns (on 2 ranks
    rank 0 stores all of ``u``), so it is gathered whole and each rank
    takes its ``u`` and ``z`` columns; its gradient is summed over
    ``model`` (a reduce-scatter), as each rank's covers only its own
    columns."""
    if mamba_ranks(cfg, plan) == 1:
        return {}
    out = {k: OWN for k in ("conv_w", "conv_b", "w_xdt", "w_dt", "dt_bias",
                            "w_bc", "log_a", "d_skip", "w_out")}
    out["w_in"] = SUMMED
    return out


def _mamba_bcdt(p, u, m: int = 1):
    """u (..., di) -> dt (softplus), B, C.  On ``m`` ranks ``u`` is this
    rank's ``di/m`` channels: the (…, dt_rank) and (…, 2·ds) projections
    are partial sums, summed over ``model`` both ways."""
    ds = p["log_a"].shape[1]
    a, bc = u @ p["w_xdt"], u @ p["w_bc"]
    if m > 1:
        a, bc = sum_over_model(a), sum_over_model(bc)
    dt = f32(F.softplus(a @ p["w_dt"] + p["dt_bias"].to(u.dtype)))
    return dt, f32(bc[..., :ds]), f32(bc[..., ds:])


# One (B, chunk, di, ds) float32 tensor of the scan stays within this budget.
SCAN_CHUNK_BYTES = 32 << 20


def scan_chunk(B: int, S: int, di: int, ds: int) -> int:
    """The scan's chunk length: the most steps whose (B, chunk, di, ds)
    float32 tensor fits ``SCAN_CHUNK_BYTES`` (at least 1, at most S).
    The reference's 128-step chunks, cut to a divisor of S, are a memory
    choice too: its steps run in the same order whatever their length."""
    return max(1, min(S, SCAN_CHUNK_BYTES // (B * di * ds * 4)))


def _scan_pairs(a, b, reverse: bool = False) -> None:
    """In place along dim 1, Hillis–Steele, log2(n) rounds: the inclusive
    scan of the pairs (a_t, b_t) under (a1, b1)∘(a2, b2) = (a1·a2,
    a2·b1 + b2), so that b_t becomes the recurrence h_t = a_t·h_{t-1} +
    b_t from h_{-1} = 0.  ``reverse`` runs it from the end: b_t = b_t +
    a_t·b_{t+1}.  ``a`` is left as scratch (its last round is skipped).
    Every product is of factors in (0, 1], never an exp of a sum."""
    n, k = a.shape[1], 1
    while k < n:
        w, r = (slice(0, n - k), slice(k, n)) if reverse else \
            (slice(k, n), slice(0, n - k))
        aw, bw = a[:, w], b[:, w]
        bw += aw * b[:, r]
        if 2 * k < n:
            aw.copy_(aw * a[:, r])
        k *= 2


def _decay(dt, A):
    """exp(dt·A), (B, c, di, ds)."""
    return torch.mul(dt[..., None], A).exp_()


class _MambaScan(torch.autograd.Function):
    """The selective scan h_t = exp(dt_t·A)·h_{t-1} + dt_t·u_t·B_t, y_t =
    h_t·C_t, chunk by chunk.  Forward saves the inputs and each chunk's
    entry state; backward recomputes a chunk's states from its entry state
    and runs the reverse recurrence g_t = dy_t ⊗ C_t + exp(dt_{t+1}·A)·
    g_{t+1} with the same scan, carrying g across chunks.  At most four
    (B, chunk, di, ds) tensors are live at once."""

    @staticmethod
    def forward(ctx, dt, u, Bm, Cm, A, h0, chunk: int):
        S = dt.shape[1]
        starts = range(0, S, chunk)
        entry = h0.new_empty((len(starts),) + h0.shape)
        y = torch.empty_like(dt)
        h = h0
        for i, c0 in enumerate(starts):
            sl = slice(c0, c0 + chunk)
            entry[i] = h
            a = _decay(dt[:, sl], A)
            b = (dt[:, sl] * u[:, sl])[..., None] * Bm[:, sl, None, :]
            b[:, 0].addcmul_(a[:, 0], h)                  # h_0 from h_in
            _scan_pairs(a, b)                             # h_t, (B, c, di, ds)
            del a
            y[:, sl] = torch.einsum("bcin,bcn->bci", b, Cm[:, sl])
            h = b[:, -1].clone()
        ctx.chunk = chunk
        ctx.save_for_backward(dt, u, Bm, Cm, A, entry)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        dt, u, Bm, Cm, A, entry = ctx.saved_tensors
        chunk, S = ctx.chunk, dt.shape[1]
        d_dt, d_u = torch.empty_like(dt), torch.empty_like(u)
        d_B, d_C = torch.empty_like(Bm), torch.empty_like(Cm)
        d_A = torch.zeros_like(A)
        g_in = dh                                  # dL/dh at the chunk's end
        for i in reversed(range(len(entry))):
            sl = slice(i * chunk, min(S, (i + 1) * chunk))
            dt_c, u_c, B_c, C_c = dt[:, sl], u[:, sl], Bm[:, sl], Cm[:, sl]
            dy_c, h_in = dy[:, sl], entry[i]
            a = _decay(dt_c, A)
            h = (dt_c * u_c)[..., None] * B_c[:, :, None, :]
            h[:, 0].addcmul_(a[:, 0], h_in)
            _scan_pairs(a, h)                             # h_t
            del a
            d_C[:, sl] = torch.einsum("bci,bcin->bcn", dy_c, h)
            w = _decay(dt_c, A)                           # exp(dt_t·A)·h_{t-1}
            w[:, 1:] *= h[:, :-1]
            w[:, 0] *= h_in
            del h
            g = dy_c[..., None] * C_c[:, :, None, :]
            g[:, -1] += g_in
            _scan_pairs(_decay(torch.roll(dt_c, -1, 1), A), g,
                        reverse=True)                     # g_t = dL/dh_t
            s = torch.einsum("bcin,bcn->bci", g, B_c)     # through dt·u·B
            d_B[:, sl] = torch.einsum("bcin,bci->bcn", g, dt_c * u_c)
            g_in = _decay(dt_c[:, 0], A) * g[:, 0]        # dL/dh_in
            q = g.mul_(w)                                 # through exp(dt·A)
            del w
            d_dt[:, sl] = torch.einsum("bcin,in->bci", q, A) + s * u_c
            d_u[:, sl] = s * dt_c
            d_A += torch.einsum("bcin,bci->in", q, dt_c)
        return d_dt, d_u, d_B, d_C, d_A, g_in, None


def mamba_scan(dt, u, Bm, Cm, A, h0, chunk: int | None = None):
    """The selective scan over S steps: dt, u (B, S, di), Bm, Cm (B, S,
    ds), A (di, ds), h0 (B, di, ds), all float32 -> y (B, S, di) (without
    the ``d_skip`` term) and the last state.  ``chunk`` defaults to
    ``scan_chunk``; the last chunk may be short.  One step (decode) is
    the recurrence's two ops, with no chunk."""
    B, S, di = dt.shape
    if S == 1:
        h = torch.exp(dt[:, 0, :, None] * A) * h0 \
            + (dt[:, 0] * u[:, 0])[..., None] * Bm[:, 0, None, :]
        return torch.einsum("bds,bs->bd", h, Cm[:, 0])[:, None], h
    if chunk is None:
        chunk = scan_chunk(B, S, di, A.shape[1])
    return _MambaScan.apply(dt, u, Bm, Cm, A, h0, chunk)


def _mamba_scan_steps(dt, u, Bm, Cm, A, h):
    """The plain version of ``mamba_scan``: the reference's ``lax.scan``
    of the recurrence, one step at a time."""
    ys = []
    for t in range(dt.shape[1]):
        h = torch.exp(dt[:, t, :, None] * A) * h \
            + (dt[:, t] * u[:, t])[..., None] * Bm[:, t, None, :]
        ys.append(torch.einsum("bds,bs->bd", h, Cm[:, t]))
    return torch.stack(ys, dim=1), h


def mamba_apply(p, x, conv_state, h_state, cfg: ArchConfig,
                plan: ShardingPlan):
    """x (B,S,d) -> (y, (conv_state, h_state)). h (B,di,ds) f32,
    conv_state (B, d_conv-1, di) (their ``di/m`` channels on a split)."""
    m = mamba_ranks(cfg, plan)
    x_in = enter_region(x, m > 1)
    B, S, d = x_in.shape
    di = cfg.expand * d
    dc = cfg.d_conv
    if m > 1:        # this rank's u and z columns of the whole w_in
        n = di // m
        w_in = p["w_in"]
        u = x_in @ w_in.narrow(-1, tp_rank() * n, n)
        z = x_in @ w_in.narrow(-1, di + tp_rank() * n, n)
    else:
        xz = x_in @ p["w_in"]
        u, z = xz[..., :di], xz[..., di:]
    # causal depthwise conv over the sequence
    u_pad = torch.cat([conv_state.to(u.dtype), u], dim=1)
    new_conv_state = u_pad[:, -(dc - 1):]
    stack = torch.stack([u_pad[:, i:i + S] for i in range(dc)], dim=-1)
    u = torch.einsum("bsdc,cd->bsd", stack, p["conv_w"]) + p["conv_b"]
    u = F.silu(u)

    dt, Bm, Cm = _mamba_bcdt(p, u, m)                     # (B,S,di),(B,S,ds)
    A = -torch.exp(p["log_a"])                            # (di, ds)
    uf = f32(u)
    y, h_state = mamba_scan(dt, uf, Bm, Cm, A, h_state)
    y = y + uf * p["d_skip"]                              # (B,S,di)
    y = leave_region((y.to(x.dtype) * F.silu(z)) @ p["w_out"], m > 1)
    return constrain(y, plan, ("batch", None, "fsdp")), \
        (new_conv_state.to(x.dtype), h_state)


def mamba_step(p, x, conv_state, h_state, cfg: ArchConfig,
               plan: ShardingPlan):
    """Single-token decode; same caches as mamba_apply."""
    return mamba_apply(p, x, conv_state, h_state, cfg, plan)
