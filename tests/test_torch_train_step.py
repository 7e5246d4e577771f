"""The port's training step (``repro_torch.launch.steps.make_train_step``)
against the reference's jitted one, the chunked cross entropy, remat, and
the data stream.

- ``make_train_step`` at ``grad_accum`` 1 and 2, one step from carried
  parameters and a carried optimizer state (nonzero m and v, count 3):
  the new parameters within ``STEP_TOL`` of each leaf's largest |p|, m
  and v within ``GRAD_TOL`` (the gradients they are made of), the metrics
  within ``LOSS_TOL`` (``tests/test_torch_train_parts.py``);
- ``_xent_chunked`` with ``chunk=16`` at S=64 (four chunks), its sums and
  their gradients with respect to the hidden states and the unembedding;
- remat: gradients with ``remat=True`` and ``remat=False`` bitwise equal
  on the CPU (the recomputation repeats the same operations);
- ``host_batch``: bitwise the reference's, for several steps, plain and
  with encoder frames and patch embeddings.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compat
from repro.configs import NO_SHARDING as R_NO_SHARDING
from repro.data import pipeline as RD
from repro.launch import steps as RS
from repro.launch.mesh import make_local_mesh
from repro.train.optimizer import OptConfig as ROptConfig
from repro_torch.configs import NO_SHARDING, ShapeConfig
from repro_torch.data import pipeline as PD
from repro_torch.launch import steps as PS
from repro_torch.models import _xent_chunked, loss_fn
from repro_torch.models.layers import tree_map
from repro_torch.train.optimizer import OptConfig, leaves, value_and_grad
from test_torch_threads import one_torch_thread  # noqa: F401
from test_torch_train_parts import (GRAD_TOL, LOSS_TOL, STEP_TOL, as_port,
                                    as_ref, batch, close, close_trees,
                                    configs, equal_trees, port_tree,
                                    ref_params)

OPT = dict(peak_lr=1e-3, warmup_steps=2, total_steps=50)


def _state(params: dict, seed: int = 7) -> dict:
    """A carried optimizer state: m ~ N(0, 1e-3), v ~ |N(0, 1e-5)|."""
    r = np.random.default_rng(seed)
    mv = lambda s: lambda a: (s(r.normal(0, 1, a.shape)) * 1e-3).astype(  # noqa: E731
        np.float32)
    return {"m": jax.tree.map(mv(lambda x: x), params),
            "v": jax.tree.map(mv(lambda x: np.abs(x) * 1e-2), params),
            "count": np.int32(3)}


@pytest.mark.parametrize("name,M", [("qwen3_0_6b", 1), ("qwen3_0_6b", 2),
                                    ("moonshot_v1_16b_a3b", 2)])
def test_train_step_matches_the_reference(name, M):
    rcfg, cfg = configs(name)
    rcfg = dataclasses.replace(rcfg, grad_accum=M)
    cfg = dataclasses.replace(cfg, grad_accum=M)
    rp = ref_params(rcfg)
    st = _state(rp)
    b = batch(rcfg, 4, 32, step=3)
    rstep = jax.jit(RS.make_train_step(rcfg, R_NO_SHARDING,
                                       ROptConfig(**OPT)))
    with compat.set_mesh(make_local_mesh()):   # the reference's M > 1 path
        r_par, r_st, r_met = rstep(rp, st, as_ref(b))   # constrains shardings
    pp, pst = port_tree(rp), port_tree(st)
    p_par, p_st, p_met = PS.make_train_step(cfg, NO_SHARDING, OptConfig(**OPT))(
        pp, pst, as_port(b))
    assert p_met.keys() == r_met.keys(), (p_met.keys(), r_met.keys())
    for k in r_met:
        close(p_met[k], r_met[k], LOSS_TOL, f"{name} M={M} {k}")
    pe = close_trees(p_par, r_par, STEP_TOL, f"{name} M={M} params")
    me = max(close_trees(p_st[k], r_st[k], GRAD_TOL, f"{name} M={M} {k}")
             for k in ("m", "v"))
    assert int(p_st["count"]) == 4 and p_st["count"].dtype == torch.int32
    # the inputs are left as they were
    equal_trees(pp, port_tree(rp), "params after the step")
    print(f"{name} M={M}: params {pe:.1e}, m/v {me:.1e}")


def test_grad_accum_splits_the_batch_as_the_reference():
    x = np.arange(3 * 4 * 5).reshape(3, 4, 5)
    for axis in (0, 1):
        want = np.asarray(RS._split_micro(jnp.asarray(x), 2 if axis else 3,
                                          axis))
        got = PS._split_micro(torch.from_numpy(x), 2 if axis else 3, axis)
        np.testing.assert_array_equal(got.numpy(), want)


def test_xent_chunked_runs_several_chunks_like_the_reference():
    from repro.models import model as RM
    r = np.random.default_rng(0)
    B, S, d, V = 2, 64, 16, 40
    x = r.normal(size=(B, S, d)).astype(np.float32)
    w = r.normal(size=(d, V)).astype(np.float32)
    lab = r.integers(0, V, (B, S)).astype(np.int32)

    def ref(x, w):
        nll, z2 = RM._xent_chunked(x, w, jnp.asarray(lab), R_NO_SHARDING,
                                   chunk=16)
        return nll + z2, (nll, z2)
    (_, (rn, rz)), (gx, gw) = jax.value_and_grad(ref, argnums=(0, 1),
                                                 has_aux=True)(
        jnp.asarray(x), jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    pn, pz = _xent_chunked(xt, wt, torch.from_numpy(lab), NO_SHARDING,
                           chunk=16)
    (pn + pz).backward()
    close(pn, rn, LOSS_TOL, "nll")
    close(pz, rz, LOSS_TOL, "z2")
    close(xt.grad, gx, GRAD_TOL, "d hidden")
    close(wt.grad, gw, GRAD_TOL, "d unembedding")
    with pytest.raises(AssertionError):
        _xent_chunked(xt[:, :48], wt, torch.from_numpy(lab[:, :48]),
                      NO_SHARDING, chunk=32)


@pytest.mark.parametrize("name", ["qwen3_0_6b", "jamba_v0_1_52b",
                                  "whisper_small"])
def test_remat_gradients_are_bitwise(name):
    rcfg, cfg = configs(name)
    assert cfg.remat
    pp = port_tree(ref_params(rcfg))
    b = as_port(batch(rcfg, 2, 32))
    out = {}
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        loss, _, grads = value_and_grad(
            lambda p, bb: loss_fn(p, bb, c, NO_SHARDING), pp, b)
        out[remat] = (loss, grads)
    assert torch.equal(out[True][0], out[False][0])
    equal_trees(out[True][1], out[False][1], f"{name} remat grads")


@pytest.mark.parametrize("name", ["qwen3_0_6b", "whisper_small",
                                  "qwen2_vl_72b"])
def test_host_batch_is_bitwise_the_reference(name):
    rcfg, cfg = configs(name)
    for step in (0, 1, 7, 123):
        rdc = RD.DataConfig(vocab_size=rcfg.vocab_size, seq_len=24,
                            global_batch=3, seed=5)
        pdc = PD.DataConfig(vocab_size=cfg.vocab_size, seq_len=24,
                            global_batch=3, seed=5)
        want, got = RD.host_batch(rdc, step, rcfg), PD.host_batch(pdc, step,
                                                                  cfg)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert dataclasses.asdict(pdc) == dataclasses.asdict(rdc)


def test_loader_replays_the_stream_on_the_device():
    _, cfg = configs("qwen2_vl_72b")
    dc = PD.DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=2)
    a = PD.DataLoader(dc, None, NO_SHARDING, cfg, device="cpu")
    first = [next(a) for _ in range(3)]
    b = PD.DataLoader(dc, None, NO_SHARDING, cfg, start_step=2, device="cpu")
    equal_trees(next(b), first[2], "replayed batch")
    assert first[0]["pos3"].shape == (3, 2, 16)
    assert first[0]["tokens"].dtype == torch.int32
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PD.DataLoader(dc, None, NO_SHARDING, cfg)


def test_batch_defs_match_the_reference():
    from repro.configs import ShapeConfig as RShape
    for name in ("qwen3_0_6b", "whisper_small", "qwen2_vl_72b"):
        rcfg, cfg = configs(name)
        for kind in ("train", "prefill", "decode"):
            for dec in (False, True):
                rd = RS.batch_defs(rcfg, RShape("s", kind, 32, 4), decode=dec)
                pd = PS.batch_defs(cfg, ShapeConfig("s", kind, 32, 4),
                                   decode=dec)
                assert list(rd) == list(pd)
                for k in rd:
                    assert (rd[k].shape, rd[k].dims, rd[k].dtype) == (
                        pd[k].shape, pd[k].dims, pd[k].dtype), (name, k)


def test_prefill_and_decode_steps_run():
    rcfg, cfg = configs("qwen3_0_6b")
    pp = port_tree(ref_params(rcfg))
    toks = torch.from_numpy(batch(rcfg, 2, 8)["tokens"])
    cache, logits = PS.make_prefill_step(cfg, NO_SHARDING, 12)(
        pp, {"tokens": toks})
    cache, nxt = PS.make_decode_step(cfg, NO_SHARDING)(
        pp, cache, {"tokens": torch.argmax(logits, -1).to(torch.int32)})
    assert tuple(nxt.shape) == (2, 1) and int(cache["pos"]) == 9
    assert not any(t.requires_grad for t in leaves(tree_map(lambda t: t,
                                                            cache)))
