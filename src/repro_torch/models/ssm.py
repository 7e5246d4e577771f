"""Attention-free sequence mixers: RWKV6 ("Finch") and Mamba (for Jamba) —
the port of ``repro.models.ssm``.

RWKV6 time-mix uses data-dependent per-channel decays, in the *chunked*
parallel form (GLA-style): within a chunk of length C the decays are
handled with cumulative log-decay matrices (f32), across chunks a recurrent
state (B, H, dk, dv) is carried by a loop over S/C steps (the reference's
``lax.scan``).  A step form (``rwkv6_step``) serves decode with O(1) state.

Mamba is the classic selective SSM: causal depthwise conv + input-dependent
(dt, B, C) and a diagonal state recurrence carried over the sequence in
chunks of 128 steps; decode keeps (conv window, h) as cache.  States and
the decay's clips are float32, as in the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, ShardingPlan
from .layers import ParamDef, constrain, f32, rms_norm

# --------------------------------------------------------------------------
# RWKV6


def rwkv6_defs(cfg: ArchConfig, dt: str) -> dict:
    d = cfg.d_model
    H = max(d // 64, 1)                      # head_size 64 (RWKV convention)
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


def _rwkv6_inputs(p, x, x_prev):
    """Token-shifted projections. x (B,S,d); x_prev (B,1,d) last token of
    previous segment (zeros at sequence start)."""
    xs = torch.cat([x_prev, x[:, :-1]], dim=1)            # shifted
    mix = torch.sigmoid(p["mix"]).to(x.dtype)             # (5, d)

    def mixed(i):
        return x + (xs - x) * mix[i]
    r = mixed(0) @ p["w_r"]
    k = mixed(1) @ p["w_k"]
    v = mixed(2) @ p["w_v"]
    g = F.silu(mixed(3) @ p["w_g"])
    lw = p["decay_w0"] + torch.tanh(mixed(4) @ p["decay_a"]) @ p["decay_b"]
    # log decay in [-5, 0): the lower clamp bounds the intra-chunk exponent
    # (chunk=16 -> |cum| <= 80 < log(f32 max)), exactly as chunked GLA does.
    log_w = -torch.clamp(torch.exp(torch.clamp(f32(lw), -10.0, 6.0)),
                         1e-6, 5.0)
    return r, k, v, g, log_w


def rwkv6_chunked(p, x, x_prev, state, cfg: ArchConfig,
                  plan: ShardingPlan, chunk: int = 16):
    """x (B,S,d) -> (y, (x_last, state)). state (B,H,dk,dv) f32."""
    B, S, d = x.shape
    H = max(d // 64, 1)
    dk = d // H
    r, k, v, g, log_w = _rwkv6_inputs(p, x, x_prev)
    u = p["bonus_u"].reshape(H, dk)

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
    ys = []
    for n in range(N):
        rc, kc, vc, lwc = rs[n], ks[n], vs[n], lws[n]    # (B,H,C,*)
        cum = torch.cumsum(lwc, dim=2)                    # inclusive Σ log w
        total = cum[:, :, -1:]                            # (B,H,1,dk)
        # decay of state contribution up to each position (exclusive)
        dec_q = torch.exp(cum - lwc)                      # Π_{s<t} w_s
        r_dec = rc * dec_q
        # inter-chunk: r_t · (Π_{s<t} w) · state
        y_inter = torch.einsum("bhck,bhkv->bhcv", r_dec, state)
        # intra-chunk: pairwise decays Π_{s<t..} via cum differences
        ki = kc * torch.exp(-cum)                         # k_s / Π_{u<=s} w
        att = torch.einsum("bhck,bhsk->bhcs", r_dec, ki)
        att = torch.where(mask, att, 0.0)
        y_intra = torch.einsum("bhcs,bhsv->bhcv", att, vc)
        # current-token bonus u
        y_diag = torch.einsum("bhck,bhck->bhc", rc * u[None, :, None, :],
                              kc)[..., None] * vc
        # state update: S' = diag(Πw) S + Σ_s (Π_{u>s} w ⊙ k_s)^T v_s
        k_dec = kc * torch.exp(total - cum)
        state = (torch.exp(total).transpose(2, 3) * state
                 + torch.einsum("bhsk,bhsv->bhkv", k_dec, vc))
        ys.append(y_inter + y_intra + y_diag)
    # (N,B,H,C,dv) -> (B,S,d)
    y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(B, S, d)
    y = rms_norm(y.to(x.dtype), p["ln_x"], cfg.rms_eps) * g
    out = y @ p["w_o"]
    out = constrain(out, plan, ("batch", None, "fsdp"))
    return out, (x[:, -1:], state)


def rwkv6_step(p, x, x_prev, state, cfg: ArchConfig, plan: ShardingPlan):
    """Single-token decode. x (B,1,d); state (B,H,dk,dv)."""
    B, _, d = x.shape
    H = max(d // 64, 1)
    dk = d // H
    r, k, v, g, log_w = _rwkv6_inputs(p, x, x_prev)
    u = p["bonus_u"].reshape(H, dk)
    rh = f32(r).reshape(B, H, dk)
    kh = f32(k).reshape(B, H, dk)
    vh = f32(v).reshape(B, H, dk)
    w = torch.exp(log_w.reshape(B, H, dk))
    kv = torch.einsum("bhk,bhv->bhkv", kh, vh)
    y = torch.einsum("bhk,bhkv->bhv", rh, state + u[None, :, :, None] * kv)
    state = w[..., None] * state + kv
    y = y.reshape(B, 1, d).to(x.dtype)
    y = rms_norm(y, p["ln_x"], cfg.rms_eps) * g
    return y @ p["w_o"], (x, state)


def rwkv6_ffn_defs(cfg: ArchConfig, dt: str) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w_k": ParamDef((d, f), ("fsdp", "tp"), dtype=dt),
        "w_v": ParamDef((f, d), ("tp", "fsdp"), dtype=dt),
        "w_r": ParamDef((d, d), ("fsdp", "tp"), dtype=dt),
        "mix": ParamDef((2, d), (None, None), init="zeros", dtype="float32"),
    }


def rwkv6_ffn(p, x, x_prev, cfg: ArchConfig, plan: ShardingPlan):
    """RWKV channel-mix: relu² K, sigmoid receptance gate."""
    xs = torch.cat([x_prev, x[:, :-1]], dim=1)
    mix = torch.sigmoid(p["mix"]).to(x.dtype)
    xk = x + (xs - x) * mix[0]
    xr = x + (xs - x) * mix[1]
    kk = torch.square(torch.relu(xk @ p["w_k"]))
    out = torch.sigmoid(xr @ p["w_r"]) * (kk @ p["w_v"])
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


def _mamba_bcdt(p, u):
    """u (..., di) -> dt (softplus), B, C."""
    ds = p["log_a"].shape[1]
    dt = f32(F.softplus((u @ p["w_xdt"]) @ p["w_dt"]
                        + p["dt_bias"].to(u.dtype)))
    bc = u @ p["w_bc"]
    return dt, f32(bc[..., :ds]), f32(bc[..., ds:])


def mamba_apply(p, x, conv_state, h_state, cfg: ArchConfig,
                plan: ShardingPlan):
    """x (B,S,d) -> (y, (conv_state, h_state)). h (B,di,ds) f32,
    conv_state (B, d_conv-1, di)."""
    B, S, d = x.shape
    di = cfg.expand * d
    dc = cfg.d_conv
    xz = x @ p["w_in"]
    u, z = xz[..., :di], xz[..., di:]
    # causal depthwise conv over the sequence
    u_pad = torch.cat([conv_state.to(u.dtype), u], dim=1)
    new_conv_state = u_pad[:, -(dc - 1):]
    stack = torch.stack([u_pad[:, i:i + S] for i in range(dc)], dim=-1)
    u = torch.einsum("bsdc,cd->bsd", stack, p["conv_w"]) + p["conv_b"]
    u = F.silu(u)

    dt, Bm, Cm = _mamba_bcdt(p, u)                        # (B,S,di),(B,S,ds)
    A = -torch.exp(p["log_a"])                            # (di, ds)
    uf = f32(u)

    # chunked selective scan: exp(dt·A) over the whole sequence would be
    # (B,S,di,ds); chunks of ck steps keep the working set (B,ck,di,ds)
    # while the recurrence stays exact.
    ck = 128
    while S % ck != 0:
        ck -= 1
    ys = []
    for c0 in range(0, S, ck):
        dt_c, u_c = dt[:, c0:c0 + ck], uf[:, c0:c0 + ck]
        B_c, C_c = Bm[:, c0:c0 + ck], Cm[:, c0:c0 + ck]
        dA = torch.exp(dt_c[..., None] * A)               # (B,ck,di,ds)
        dBu = (dt_c * u_c)[..., None] * B_c[:, :, None, :]
        for t in range(dt_c.shape[1]):
            h_state = dA[:, t] * h_state + dBu[:, t]      # (B,di,ds)
            ys.append(torch.einsum("bds,bs->bd", h_state, C_c[:, t]))
    y = torch.stack(ys, dim=1) + uf * p["d_skip"]         # (B,S,di)
    y = (y.to(x.dtype) * F.silu(z)) @ p["w_out"]
    return constrain(y, plan, ("batch", None, "fsdp")), \
        (new_conv_state.to(x.dtype), h_state)


def mamba_step(p, x, conv_state, h_state, cfg: ArchConfig,
               plan: ShardingPlan):
    """Single-token decode; same caches as mamba_apply."""
    return mamba_apply(p, x, conv_state, h_state, cfg, plan)
