"""The port's LM layers (``repro_torch.models``: blockwise attention, GQA,
MLA, MoE, RWKV6, Mamba, the elementary ops) against the reference's same
functions run live on the same numpy inputs and parameters, plus the port's
forms of ``tests/test_models.py``'s ``TestBlockwise``, ``TestRWKV6``,
``TestMamba``, ``TestMoE`` and ``TestMLA``.

Tolerances: float32 results agree within ``TOL`` (1e-5) relative to the
reference's largest magnitude: both compute the same float32 operations and
differ only in the order of summation (measured at most 5.4e-7 here).  The
bfloat16 cases agree within ``BF16_TOL``, one bf16 step (2^-8 relative):
the port upcasts where the reference asks for float32 results and rounds
to bf16 where it does, so the two round the same float32 values (measured
bitwise equal here); a sum taken in another order may still move one
rounding by a step.  A port that kept the scores in bf16 fails it.
Within-port checks keep the reference test's own tolerances.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import NO_SHARDING as RNS
from repro.configs import get_arch as r_get_arch
from repro.configs import smoke_of as r_smoke_of
from repro.models import attention as RA
from repro.models import layers as RL
from repro.models import moe as RMoE
from repro.models import ssm as RSSM
from repro_torch.configs import NO_SHARDING as NS
from repro_torch.configs import get_arch, smoke_of
from repro_torch.models import attention as PA
from repro_torch.models import layers as PL
from repro_torch.models import moe as PMoE
from repro_torch.models import params_from_numpy
from repro_torch.models import ssm as PSSM
from test_torch_threads import one_torch_thread  # noqa: F401

TOL, BF16_TOL = 1e-5, 2.0 ** -8


def cfgs(name: str, **over):
    r, p = r_smoke_of(r_get_arch(name)), smoke_of(get_arch(name))
    if over:
        r, p = dataclasses.replace(r, **over), dataclasses.replace(p, **over)
    return r, p


def ref_init(defs: dict, seed: int = 0) -> dict:
    """The reference's ``init_params`` (one key per sorted path) over a
    nested table (of either package's ``ParamDef``), as numpy."""
    flat = {k: RL.ParamDef(**dataclasses.asdict(d))
            for k, d in PL.flatten(defs).items()}
    flat = RL.init_params(flat, jax.random.key(seed))
    return PL.unflatten({k: np.asarray(v) for k, v in flat.items()})


def both(defs: dict, seed: int = 0, dtype=None):
    """(reference params as jax arrays, the port's tensors) of one draw."""
    tree = ref_init(defs, seed)
    rp = PL.tree_map(jnp.asarray, tree)
    if dtype is not None:
        rp = PL.tree_map(lambda a: a.astype(dtype) if a.dtype == jnp.float32
                         else a, rp)
    return rp, params_from_numpy(PL.tree_map(np.asarray, rp), "cpu")


def normal(r, shape, sd=1.0):
    return r.normal(0, sd, shape).astype(np.float32)


def close(got, want, what="", tol=TOL):
    g = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    w = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert g.shape == w.shape, (what, g.shape, w.shape)
    scale = max(float(np.abs(w).max()), 1e-30)
    err = float(np.abs(g.astype(np.float64) - w).max())
    assert err <= tol * scale, f"{what}: max |diff| {err} > {tol} x {scale}"


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def naive_attention(q, k, v, causal):
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    qh = q.reshape(B, Sq, Hkv, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qh.float(), k.float()) * (D ** -0.5)
    if causal:
        mask = torch.tril(torch.ones((Sq, Sk), dtype=torch.bool),
                          diagonal=Sk - Sq)
        s = torch.where(mask, s, -1e30)
    p = torch.softmax(s, -1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, Sq, H, v.shape[3])


# --------------------------------------------------------------------------
# elementary ops


def test_norms_rope_positions_and_ffns_match_the_reference():
    r = np.random.default_rng(0)
    x = normal(r, (2, 6, 4, 32))
    g, b = normal(r, (32,)), normal(r, (32,))
    close(PL.rms_norm(T(x), T(g)), RL.rms_norm(x, g), "rms_norm")
    close(PL.layer_norm(T(x), T(g), T(b)), RL.layer_norm(x, g, b),
          "layer_norm")
    pos = np.arange(6, dtype=np.int32)[None] + np.array([[0], [5]], np.int32)
    close(PL.apply_rope(T(x), T(pos), 1e6), RL.apply_rope(x, pos, 1e6),
          "rope")
    pos3 = np.stack([pos, pos * 2, pos + 3])
    sec = RA._mrope_sections(32)
    assert PA._mrope_sections(32) == sec
    close(PL.apply_m_rope(T(x), T(pos3), sec, 1e4),
          RL.apply_m_rope(x, pos3, sec, 1e4), "m_rope")
    close(PL.sinusoidal_from_pos(T(pos), 64),
          RL.sinusoidal_from_pos(pos, 64), "sinusoidal_from_pos")
    h = normal(r, (3, 16))
    w1, w2, w3 = normal(r, (16, 24)), normal(r, (16, 24)), normal(r, (24, 16))
    close(PL.swiglu(T(h), T(w1), T(w2), T(w3)), RL.swiglu(h, w1, w2, w3),
          "swiglu")
    close(PL.geglu(T(h), T(w1), T(w2), T(w3)), RL.geglu(h, w1, w2, w3),
          "geglu")


# --------------------------------------------------------------------------
# blockwise attention


class TestBlockwise:
    @pytest.mark.parametrize("causal,sq,sk,h,hkv", [
        (True, 64, 64, 4, 4), (True, 64, 64, 4, 1), (False, 64, 64, 4, 4),
        (False, 64, 64, 4, 1), (False, 96, 48, 4, 2)])
    def test_matches_naive_and_the_reference(self, causal, sq, sk, h, hkv):
        r = np.random.default_rng(0)
        q = normal(r, (2, sq, h, 16))
        k, v = normal(r, (2, sk, hkv, 16)), normal(r, (2, sk, hkv, 16))
        got = PA._blockwise(T(q), T(k), T(v), causal=causal,
                            scale=16 ** -0.5, q_block=32, kv_block=16)
        np.testing.assert_allclose(got.numpy(), naive_attention(
            T(q), T(k), T(v), causal).numpy(), atol=2e-5, rtol=2e-5)
        close(got, RA._blockwise(q, k, v, causal=causal, scale=16 ** -0.5,
                                 q_block=32, kv_block=16), "blockwise")

    def test_block_size_invariance(self):
        r = np.random.default_rng(1)
        q, k, v = (T(normal(r, (1, 60, 2, 8))) for _ in range(3))
        a = PA._blockwise(q, k, v, causal=True, scale=1.0, q_block=60,
                          kv_block=60)
        b = PA._blockwise(q, k, v, causal=True, scale=1.0, q_block=20,
                          kv_block=12)
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5)

    @pytest.mark.parametrize("sq,target", [(513, 512), (60, 16), (7, 4)])
    def test_the_reference_block_sizes(self, sq, target):
        """The same `pick`: the largest block <= target dividing S."""
        want = max(b for b in range(1, min(target, sq) + 1) if sq % b == 0)
        assert PA._pick(sq, target) == want

    def test_bf16_accumulates_in_float32_as_the_reference(self):
        """Large scores (q, k of sd 4), where rounding them to bf16 moves
        the softmax: a port that did so misses by 2e-2 of the output."""
        r = np.random.default_rng(2)
        q = jnp.asarray(normal(r, (2, 48, 4, 32), 4.0), jnp.bfloat16)
        k = jnp.asarray(normal(r, (2, 48, 2, 32), 4.0), jnp.bfloat16)
        v = jnp.asarray(normal(r, (2, 48, 2, 32)), jnp.bfloat16)
        want = RA._blockwise(q, k, v, causal=True, scale=32 ** -0.5,
                             q_block=16, kv_block=16)
        pq, pk, pv = (params_from_numpy(np.asarray(a), "cpu")
                      for a in (q, k, v))
        got = PA._blockwise(pq, pk, pv, causal=True, scale=32 ** -0.5,
                            q_block=16, kv_block=16)
        assert got.dtype == torch.bfloat16
        close(got, want, "blockwise bf16", BF16_TOL)


# --------------------------------------------------------------------------
# GQA (decode on the ring buffer) and MLA


@pytest.mark.parametrize("dtype", [None, jnp.bfloat16])
@pytest.mark.parametrize("name", ["qwen3_0_6b", "qwen2_vl_72b"])
def test_gqa_prefill_and_ring_decode_match_the_reference(name, dtype):
    """prefill S tokens into S slots, then three decode steps that
    overwrite slots 0, 1, 2 (the cache `launch/serve.py` builds)."""
    rcfg, cfg = cfgs(name)
    rp, pp = both(RA.gqa_defs(rcfg, "float32"), dtype=dtype)
    tol = TOL if dtype is None else BF16_TOL
    r = np.random.default_rng(3)
    B, S, d = 2, 12, cfg.d_model
    x = jnp.asarray(normal(r, (B, S + 3, d)))
    if dtype is not None:
        x = x.astype(dtype)
    px = params_from_numpy(np.asarray(x), "cpu")
    pos = np.arange(S + 3, dtype=np.int32)[None]
    pos3 = np.broadcast_to(pos[None], (3, 1, S + 3)).copy() \
        if cfg.m_rope else None
    sl = slice(0, S)
    cdt = jnp.float32 if dtype is None else dtype
    rc = {"k": jnp.zeros((B, S, cfg.n_kv_heads, cfg.head_dim_), cdt),
          "v": jnp.zeros((B, S, cfg.n_kv_heads, cfg.head_dim_), cdt)}
    pc = params_from_numpy(jax.tree.map(np.asarray, rc), "cpu")
    ro, rc = RA.gqa_apply(rp, x[:, sl], pos[:, sl], rcfg, RNS, mode="prefill",
                          cache=rc, pos3=None if pos3 is None
                          else pos3[..., sl])
    po, pc = PA.gqa_apply(pp, px[:, sl], T(pos[:, sl]), cfg, NS,
                          mode="prefill", cache=pc,
                          pos3=None if pos3 is None else T(pos3[..., sl]))
    close(po, ro, "prefill", tol)
    for key in ("k", "v"):
        close(pc[key], rc[key], f"prefill cache {key}", tol)
    for t in range(S, S + 3):
        st = slice(t, t + 1)
        p3 = None if pos3 is None else pos3[..., st]
        ro, rc = RA.gqa_apply(rp, x[:, st], pos[:, st], rcfg, RNS,
                              mode="decode", cache=rc,
                              cache_pos=jnp.int32(t), pos3=p3)
        po, pc = PA.gqa_apply(pp, px[:, st], T(pos[:, st]), cfg, NS,
                              mode="decode", cache=pc,
                              cache_pos=torch.tensor(t, dtype=torch.int32),
                              pos3=None if p3 is None else T(p3))
        close(po, ro, f"decode {t}", tol)
        for key in ("k", "v"):
            close(pc[key], rc[key], f"decode {t} cache {key}", tol)


def test_cross_attention_matches_the_reference():
    rcfg, cfg = cfgs("whisper_small")
    rp, pp = both(RA.gqa_defs(rcfg, "float32"))
    r = np.random.default_rng(4)
    x, xe = normal(r, (2, 5, cfg.d_model)), normal(r, (2, 32, cfg.d_model))
    rkv, pkv = RA.encode_kv(rp, xe, rcfg), PA.encode_kv(pp, T(xe), cfg)
    close(pkv["k"], rkv["k"], "encode_kv")
    close(PA.gqa_cross_apply(pp, T(x), pkv, cfg, NS),
          RA.gqa_cross_apply(rp, x, rkv, rcfg, RNS), "cross")


class TestMLA:
    @pytest.mark.parametrize("name", ["deepseek_v3_671b", "minicpm3_4b"])
    def test_absorbed_decode_matches_materialized(self, name):
        """MLA decode (latent cache, absorbed matmuls) == naive K/V path."""
        _, cfg = cfgs(name)
        _, p = both(PA.mla_defs(cfg, "float32"))
        r = np.random.default_rng(0)
        B, S, d = 2, 12, cfg.d_model
        x = T(normal(r, (B, S + 1, d)))
        pos = torch.arange(S + 1)[None]
        o_full, _ = PA.mla_apply(p, x, pos, cfg, NS, mode="train")
        cache = {"c_kv": torch.zeros((B, S + 2, cfg.kv_lora_rank)),
                 "k_rope": torch.zeros((B, S + 2, cfg.qk_rope_dim))}
        _, cache1 = PA.mla_apply(p, x[:, :S], pos[:, :S], cfg, NS,
                                 mode="prefill", cache=cache)
        o_dec, _ = PA.mla_apply(p, x[:, S:S + 1], pos[:, S:S + 1], cfg, NS,
                                mode="decode", cache=cache1,
                                cache_pos=torch.tensor(S, dtype=torch.int32))
        np.testing.assert_allclose(o_dec[:, 0].numpy(), o_full[:, S].numpy(),
                                   atol=2e-3, rtol=2e-3)

    @pytest.mark.parametrize("dtype", [None, jnp.bfloat16])
    @pytest.mark.parametrize("name", ["deepseek_v3_671b", "minicpm3_4b"])
    def test_matches_the_reference(self, name, dtype):
        """train, prefill into S slots and two ring-buffer decode steps."""
        rcfg, cfg = cfgs(name)
        rp, pp = both(RA.mla_defs(rcfg, "float32"), dtype=dtype)
        tol = TOL if dtype is None else BF16_TOL
        r = np.random.default_rng(5)
        B, S, d = 2, 10, cfg.d_model
        x = jnp.asarray(normal(r, (B, S + 2, d)))
        if dtype is not None:
            x = x.astype(dtype)
        px = params_from_numpy(np.asarray(x), "cpu")
        pos = np.arange(S + 2, dtype=np.int32)[None]
        ref = jax.jit(lambda p, x, pos, c, cp, mode: RA.mla_apply(
            p, x, pos, rcfg, RNS, mode=mode, cache=c, cache_pos=cp),
            static_argnames="mode")
        ro, _ = ref(rp, x, pos, None, None, mode="train")
        po, _ = PA.mla_apply(pp, px, T(pos), cfg, NS, mode="train")
        close(po, ro, "train", tol)
        cdt = jnp.float32 if dtype is None else dtype
        rc = {"c_kv": jnp.zeros((B, S, cfg.kv_lora_rank), cdt),
              "k_rope": jnp.zeros((B, S, cfg.qk_rope_dim), cdt)}
        pc = params_from_numpy(jax.tree.map(np.asarray, rc), "cpu")
        _, rc = ref(rp, x[:, :S], pos[:, :S], rc, None, mode="prefill")
        _, pc = PA.mla_apply(pp, px[:, :S], T(pos[:, :S]), cfg, NS,
                             mode="prefill", cache=pc)
        for key in ("c_kv", "k_rope"):
            close(pc[key], rc[key], f"prefill {key}", tol)
        # XLA's CPU runtime cannot run the reference's absorbed decode in
        # bf16 (no bf16 x bf16 = f32 dot): decode is held here in float32,
        # and in bf16 by chip_smoke.py's decode equivalence on the card
        for t in ((S, S + 1) if dtype is None else ()):
            ro, rc = ref(rp, x[:, t:t + 1], pos[:, t:t + 1], rc,
                         jnp.int32(t), mode="decode")
            po, pc = PA.mla_apply(pp, px[:, t:t + 1], T(pos[:, t:t + 1]),
                                  cfg, NS, mode="decode", cache=pc,
                                  cache_pos=torch.tensor(t,
                                                         dtype=torch.int32))
            close(po, ro, f"decode {t}", tol)
            for key in ("c_kv", "k_rope"):
                close(pc[key], rc[key], f"decode {t} {key}", tol)


# --------------------------------------------------------------------------
# RWKV6 and Mamba


def _rwkv_inputs(cfg, B, S, seed):
    r = np.random.default_rng(seed)
    d = cfg.d_model
    H = max(d // 64, 1)
    return (normal(r, (B, S, d)), np.zeros((B, 1, d), np.float32),
            np.zeros((B, H, d // H, d // H), np.float32))


class TestRWKV6:
    def test_chunked_matches_stepwise(self):
        _, cfg = cfgs("rwkv6_1_6b")
        _, p = both(PSSM.rwkv6_defs(cfg, "float32"))
        B, S = 2, 24
        x, xp0, st0 = (T(a) for a in _rwkv_inputs(cfg, B, S, 0))
        y_chunk, (_, st) = PSSM.rwkv6_chunked(p, x, xp0, st0, cfg, NS,
                                              chunk=8)
        ys, xp, st2 = [], xp0, st0
        for t in range(S):
            y, (xp, st2) = PSSM.rwkv6_step(p, x[:, t:t + 1], xp, st2, cfg, NS)
            ys.append(y)
        np.testing.assert_allclose(y_chunk.numpy(), torch.cat(ys, 1).numpy(),
                                   atol=1e-3, rtol=1e-3)
        np.testing.assert_allclose(st.numpy(), st2.numpy(), atol=1e-3,
                                   rtol=1e-3)

    def test_chunk_size_invariance(self):
        _, cfg = cfgs("rwkv6_1_6b")
        _, p = both(PSSM.rwkv6_defs(cfg, "float32"), seed=1)
        x, xp0, st0 = (T(a) for a in _rwkv_inputs(cfg, 1, 32, 1))
        y1, _ = PSSM.rwkv6_chunked(p, x, xp0, st0, cfg, NS, chunk=4)
        y2, _ = PSSM.rwkv6_chunked(p, x, xp0, st0, cfg, NS, chunk=16)
        np.testing.assert_allclose(y1.numpy(), y2.numpy(), atol=1e-3,
                                   rtol=1e-3)

    def test_chunked_step_and_ffn_match_the_reference(self):
        """Nonzero decays, bonus and mixes (the smoke init leaves them at
        zero), so the clips and the float32 state are exercised."""
        rcfg, cfg = cfgs("rwkv6_1_6b")
        defs = RSSM.rwkv6_defs(rcfg, "float32")
        defs = {k: dataclasses.replace(d, init="normal", scale=2.0)
                if d.init == "zeros" else d for k, d in defs.items()}
        rp, pp = both(defs, seed=2)
        B, S = 2, 20
        x, xp, st = _rwkv_inputs(cfg, B, S, 2)
        ry, (rxl, rst) = RSSM.rwkv6_chunked(rp, x, xp, st, rcfg, RNS)
        py, (pxl, pst) = PSSM.rwkv6_chunked(pp, T(x), T(xp), T(st), cfg, NS)
        close(py, ry, "chunked")
        close(pst, rst, "chunked state")
        close(pxl, rxl, "chunked x_last")
        ry, (_, rst) = RSSM.rwkv6_step(rp, x[:, :1], xp, np.asarray(rst),
                                       rcfg, RNS)
        py, (_, pst) = PSSM.rwkv6_step(pp, T(x[:, :1]), T(xp), pst, cfg, NS)
        close(py, ry, "step")
        close(pst, rst, "step state")
        rfp, pfp = both(RSSM.rwkv6_ffn_defs(rcfg, "float32"), seed=3)
        ry, _ = RSSM.rwkv6_ffn(rfp, x, xp + 0.5, rcfg, RNS)
        py, _ = PSSM.rwkv6_ffn(pfp, T(x), T(xp + 0.5), cfg, NS)
        close(py, ry, "ffn")


class TestMamba:
    def _setup(self, seed=0):
        rcfg, cfg = cfgs("jamba_v0_1_52b")
        defs = RSSM.mamba_defs(rcfg, "float32")
        defs = {k: dataclasses.replace(d, init="normal", scale=0.5)
                if d.init == "zeros" else d for k, d in defs.items()}
        rp, pp = both(defs, seed=seed)
        return rcfg, cfg, rp, pp

    def test_streaming_matches_full(self):
        _, cfg, _, p = self._setup()
        r = np.random.default_rng(0)
        B, S, d = 2, 16, cfg.d_model
        di = cfg.expand * d
        x = T(normal(r, (B, S, d)))
        conv0 = torch.zeros((B, cfg.d_conv - 1, di))
        h0 = torch.zeros((B, di, cfg.d_state))
        y_full, _ = PSSM.mamba_apply(p, x, conv0, h0, cfg, NS)
        ys, conv, h = [], conv0, h0
        for t in range(S):
            y, (conv, h) = PSSM.mamba_step(p, x[:, t:t + 1], conv, h, cfg, NS)
            ys.append(y)
        np.testing.assert_allclose(torch.cat(ys, 1).numpy(), y_full.numpy(),
                                   atol=1e-4, rtol=1e-4)

    def test_matches_the_reference(self):
        """S=260 at smoke width (B 2, di 256): the port's byte budget
        makes it one chunk of the log-depth scan (9 rounds), where the
        reference's divisor search runs four chunks of 65 steps; several
        chunks and a ragged tail are ``tests/test_torch_mamba_scan.py``'s."""
        rcfg, cfg, rp, pp = self._setup(seed=1)
        r = np.random.default_rng(1)
        B, S, d = 2, 260, cfg.d_model
        di = cfg.expand * d
        x = normal(r, (B, S, d), 0.5)
        conv = normal(r, (B, cfg.d_conv - 1, di))
        h = normal(r, (B, di, cfg.d_state))
        ry, (rconv, rh) = RSSM.mamba_apply(rp, x, conv, h, rcfg, RNS)
        py, (pconv, ph) = PSSM.mamba_apply(pp, T(x), T(conv), T(h), cfg, NS)
        close(py, ry, "y")
        close(pconv, rconv, "conv state")
        close(ph, rh, "h state")


# --------------------------------------------------------------------------
# MoE


class TestMoE:
    def test_dispatch_combines_expert_outputs(self):
        _, cfg = cfgs("moonshot_v1_16b_a3b")
        _, p = both(PMoE.moe_defs(cfg, "float32"))
        x = T(normal(np.random.default_rng(0), (2, 16, cfg.d_model), 0.5))
        y, aux = PMoE.moe_apply(p, x, cfg, NS)
        assert y.shape == x.shape
        assert torch.isfinite(y).all()
        assert float(aux) > 0

    def test_capacity_bounds(self):
        rcfg, cfg = cfgs("deepseek_v3_671b")
        for n in (1, 16, 1000, 1024, 4096):
            c = PMoE.capacity(n, cfg)
            assert c == RMoE.capacity(n, rcfg)
            assert c >= n * cfg.n_experts_per_tok // cfg.n_experts
            assert c % 8 == 0

    def test_top_k_keeps_the_lower_index_first_on_ties(self):
        r = np.random.default_rng(0)
        probs = np.round(r.uniform(0, 1, (64, 8)), 1).astype(np.float32)
        want_v, want_i = jax.lax.top_k(probs, 3)
        got_v, got_i = PMoE.top_k(T(probs), 3)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))

    @pytest.mark.parametrize("name,cf", [("moonshot_v1_16b_a3b", 1.25),
                                         ("deepseek_v3_671b", 0.5),
                                         ("jamba_v0_1_52b", 8.0)])
    def test_matches_the_reference(self, name, cf):
        """The same tokens dropped (capacity 0.5 and 1.25 drop some), the
        same outputs and aux loss."""
        rcfg, cfg = cfgs(name, capacity_factor=cf)
        rp, pp = both(RMoE.moe_defs(rcfg, "float32"), seed=4)
        x = normal(np.random.default_rng(4), (3, 24, cfg.d_model), 0.5)
        ry, raux = RMoE.moe_apply(rp, x, rcfg, RNS)
        py, paux = PMoE.moe_apply(pp, T(x), cfg, NS)
        close(py, ry, "moe")
        close(paux, raux, "aux")
        # drops decide which tokens an expert sees: the capacity-bound
        # configs must drop some for this test to hold them
        idx = PMoE.top_k(torch.softmax(T(x) @ pp["router"], -1),
                         cfg.n_experts_per_tok)[1]
        C = PMoE.capacity(24, cfg)
        keep = PMoE._dispatch_group(T(x), idx, cfg.n_experts, C)[2]
        assert bool((~keep).any()) == (cf < 8.0)

    def test_moe_matches_dense_when_capacity_ample(self):
        """With huge capacity, sort-based dispatch == direct per-token mix."""
        _, cfg = cfgs("moonshot_v1_16b_a3b", capacity_factor=8.0)
        _, p = both(PMoE.moe_defs(cfg, "float32"))
        x = T(normal(np.random.default_rng(0), (1, 8, cfg.d_model), 0.5))
        y, _ = PMoE.moe_apply(p, x, cfg, NS)
        xf = x.reshape(8, cfg.d_model)
        probs = torch.softmax(xf @ p["router"], -1)
        g, idx = PMoE.top_k(probs, cfg.n_experts_per_tok)
        g = g / g.sum(-1, keepdim=True)
        eg, sh = p["experts"], p["shared"]
        want = torch.zeros_like(xf)
        for t in range(8):
            for j in range(cfg.n_experts_per_tok):
                e = int(idx[t, j])
                h = (torch.nn.functional.silu(xf[t] @ eg["w_gate"][e])
                     * (xf[t] @ eg["w_up"][e]))
                want[t] += g[t, j] * (h @ eg["w_down"][e])
        want += (torch.nn.functional.silu(xf @ sh["w_gate"])
                 * (xf @ sh["w_up"])) @ sh["w_down"]
        np.testing.assert_allclose(y.reshape(8, -1).numpy(), want.numpy(),
                                   atol=2e-4, rtol=2e-3)
