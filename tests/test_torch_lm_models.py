"""The port's LM forward (``repro_torch.models``) against the reference's,
for every architecture at smoke size, on the reference's own parameters
carried across (``params_from_numpy``).

The reference's parameters come from its serving initialiser
(``init_params_sharded``: one key per path), not from ``test_models.py``'s
``init_tree``, which gives every two parameters of one shape the same
values and so could not tell, e.g., ``wk`` from ``wv``.

Tolerance (float32 on both sides): logits agree within ``LOGIT_TOL``
times the largest reference logit.  Both sides compute the same float32
operations; only the order of summation inside matmuls and reductions
differs (XLA's CPU kernels against torch's), a relative error of order
1e-7 per op that grows over the smoke configs' 2-8 layers to at most
2.7e-6 of the logits' scale (measured over the ten architectures); 1e-5
leaves a margin of 3.7 (jamba's mamba scan measured 2.7e-6).  Caches
after prefill and after each decode step are held to the same bound
relative to their own scale; a bf16 cache leaf to one bf16 step (2^-8),
since float32 values a few ulps apart can round to neighbouring bf16
values.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import NO_SHARDING as R_NO_SHARDING
from repro.configs import get_arch as r_get_arch
from repro.configs import list_archs as r_list_archs
from repro.configs import smoke_of as r_smoke_of
from repro.launch.mesh import make_local_mesh
from repro.models import model as RM
from repro.models.layers import ParamDef as RParamDef
from repro.train.trainer import init_params_sharded
from repro_torch.configs import NO_SHARDING, get_arch, list_archs, smoke_of
from repro_torch.models import model as PM
from repro_torch.models import params_from_numpy
from test_torch_threads import one_torch_thread  # noqa: F401

LOGIT_TOL = 1e-5
BF16_STEP = 2.0 ** -8
B, S, N_DECODE = 2, 16, 3


def ref_params(rcfg, seed: int = 0):
    """The reference serving initialiser's parameters, as numpy."""
    mesh = make_local_mesh()
    pdefs = RM.param_defs(rcfg)
    specs = jax.tree.map(lambda d: R_NO_SHARDING.spec(d.dims, d.shape), pdefs,
                         is_leaf=lambda t: isinstance(t, RParamDef))
    return jax.tree.map(np.asarray, init_params_sharded(pdefs, mesh, specs,
                                                        seed))


def inputs(cfg, n_tokens: int, seed: int = 0) -> dict:
    r = np.random.default_rng(seed)
    out = {"tokens": r.integers(0, cfg.vocab_size, (B, n_tokens)).astype(
        np.int32)}
    if cfg.enc_dec:
        out["enc_embeds"] = r.normal(0, 1, (B, cfg.enc_len, cfg.d_model)
                                     ).astype(np.float32)
    if cfg.n_patches:
        out["patch_embeds"] = r.normal(0, 0.02, (B, cfg.n_patches,
                                                 cfg.d_model)).astype(
            np.float32)
    return out


def pos3_of(n: int):
    return np.broadcast_to(np.arange(n, dtype=np.int32)[None, None],
                           (3, B, n)).copy()


def as_port(batch: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def as_ref(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def close(got, want, what: str, tol: float = LOGIT_TOL):
    want = np.asarray(want)
    dtype = str(got.dtype).removeprefix("torch.")
    assert tuple(got.shape) == want.shape and dtype == want.dtype.name, (
        what, tuple(got.shape), want.shape, dtype, want.dtype)
    got = got.detach().double().numpy()
    want = want.astype(np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max |diff| {err} > {tol} x {scale}"


def close_trees(got: dict, want: dict, what: str):
    assert got.keys() == want.keys(), (what, got.keys(), want.keys())
    for k in want:
        if isinstance(want[k], dict):
            close_trees(got[k], want[k], f"{what}/{k}")
        elif np.asarray(want[k]).dtype.kind == "i":
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                          err_msg=f"{what}/{k}")
        else:  # a bf16 leaf (cache-less prefill's K/V) may round a step off
            close(got[k], want[k], f"{what}/{k}",
                  BF16_STEP if got[k].dtype == torch.bfloat16 else LOGIT_TOL)


def test_the_same_architectures():
    assert list_archs() == r_list_archs()


@pytest.mark.parametrize("name", r_list_archs())
def test_forward_prefill_decode_match_the_reference(name):
    """backbone("train") logits at every position, then prefill over S
    tokens into a cache of S slots and N_DECODE decode steps (the ring
    buffer wraps, as in `launch/serve.py`), logits and caches after
    each, against the reference on the same parameters and inputs."""
    rcfg, cfg = r_smoke_of(r_get_arch(name)), smoke_of(get_arch(name))
    rp = ref_params(rcfg)
    pp = params_from_numpy(rp, "cpu")
    n = S + N_DECODE
    batch = inputs(cfg, n)
    toks = batch["tokens"]
    full = dict(batch)
    if cfg.n_patches:
        full["pos3"] = pos3_of(n)

    # the full forward over all n tokens
    pos = np.arange(n, dtype=np.int32)[None]
    rx, _, _ = jax.jit(lambda p, b: RM.backbone(
        p, b["tokens"], jnp.asarray(pos), rcfg, R_NO_SHARDING, mode="train",
        pos3=b.get("pos3"), batch=b))(rp, as_ref(full))
    want = RM._unembed(rp, rx, rcfg, R_NO_SHARDING)
    pb = as_port(full)
    px, _, _ = PM.backbone(pp, pb["tokens"], torch.from_numpy(pos), cfg,
                           NO_SHARDING, mode="train", pos3=pb.get("pos3"),
                           batch=pb)
    close(PM._unembed(pp, px, cfg, NO_SHARDING), want, f"{name} train")

    # prefill over the first S tokens, cache capacity S
    pre = {k: (v[:, :S] if k == "tokens" else v) for k, v in batch.items()}
    if cfg.n_patches:
        pre["pos3"] = pos3_of(S)
    rcache, rlog = jax.jit(lambda p, b: RM.prefill(p, b, rcfg, R_NO_SHARDING,
                                                   S))(rp, as_ref(pre))
    pcache, plog = PM.prefill(pp, as_port(pre), cfg, NO_SHARDING, S)
    close(plog, rlog, f"{name} prefill logits")
    close_trees(pcache, jax.tree.map(np.asarray, rcache), f"{name} prefill")

    step = jax.jit(lambda p, c, t: RM.decode_step(p, c, t, rcfg,
                                                  R_NO_SHARDING))
    for i in range(N_DECODE):
        t = toks[:, S + i:S + i + 1]
        rcache, rlog = step(rp, rcache, jnp.asarray(t))
        pcache, plog = PM.decode_step(pp, pcache, torch.from_numpy(t), cfg,
                                      NO_SHARDING)
        close(plog, rlog, f"{name} decode {i}")
        close_trees(pcache, jax.tree.map(np.asarray, rcache),
                    f"{name} decode {i}")


@pytest.mark.parametrize("name", ["qwen3_0_6b", "minicpm3_4b", "rwkv6_1_6b",
                                  "jamba_v0_1_52b", "whisper_small"])
def test_prefill_without_a_cache_matches_the_reference(name):
    """backbone("prefill") given no cache returns the layers' caches
    stacked per run (attention K/V as bf16), as the reference's scan does."""
    rcfg, cfg = r_smoke_of(r_get_arch(name)), smoke_of(get_arch(name))
    rp = ref_params(rcfg)
    pp = params_from_numpy(rp, "cpu")
    batch = inputs(cfg, S)
    pos = np.arange(S, dtype=np.int32)[None]
    rx, _, rc = jax.jit(lambda p, b: RM.backbone(
        p, b["tokens"], jnp.asarray(pos), rcfg, R_NO_SHARDING, mode="prefill",
        batch=b))(rp, as_ref(batch))
    pb = as_port(batch)
    px, _, pc = PM.backbone(pp, pb["tokens"], torch.from_numpy(pos), cfg,
                            NO_SHARDING, mode="prefill", batch=pb)
    close(px, rx, f"{name} hidden")
    close_trees(pc, jax.tree.map(np.asarray, rc), f"{name} cache")


class TestDecodeEquivalence:
    """The port's prefill(S) + decode(1) == its full forward over S+1
    tokens (the reference's ``tests/test_models.py`` case, same tolerance)."""

    @pytest.mark.parametrize("name", ["qwen3_0_6b", "minicpm3_4b",
                                      "rwkv6_1_6b", "jamba_v0_1_52b",
                                      "gemma_2b"])
    def test_decode_matches_forward(self, name):
        cfg = smoke_of(get_arch(name))
        if cfg.is_moe:  # ample capacity: no token drops -> exact equivalence
            cfg = dataclasses.replace(cfg, capacity_factor=8.0)
        params = params_from_numpy(ref_params(r_smoke_of(r_get_arch(name))),
                                   "cpu")
        r = np.random.default_rng(0)
        Sd = 32
        toks = torch.from_numpy(r.integers(0, cfg.vocab_size, (B, Sd + 1))
                                .astype(np.int32))
        x, _, _ = PM.backbone(params, toks, torch.arange(Sd + 1)[None], cfg,
                              NO_SHARDING, mode="train")
        want = PM._unembed(params, x[:, -1:], cfg, NO_SHARDING)
        cache, _ = PM.prefill(params, {"tokens": toks[:, :Sd]}, cfg,
                              NO_SHARDING, cache_len=Sd + 4)
        cache, got = PM.decode_step(params, cache, toks[:, Sd:Sd + 1], cfg,
                                    NO_SHARDING)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=3e-2,
                                   rtol=3e-2)
        assert int(cache["pos"]) == Sd + 1
