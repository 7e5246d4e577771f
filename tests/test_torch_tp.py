"""The compute split along ``model`` (``parallel.shard.tp_ranks``: the
query heads, the MLP's hidden columns, the experts and the vocabulary,
where the reference's plan splits them) on gloo worlds of CPU ranks,
held to the reference's one-device step run live on the same numpy
inputs: one train step's loss, gradient norm and every leaf's gradient;
the parameters and AdamW's m and v after two steps; the prefill's logits
and the greedy tokens (equal up to each row's first near-tie, as in
``tests/test_torch_lm_serve.py``).

Architectures: ``qwen3-0.6b`` (GQA with ``qk_norm``; at ``model=4`` two
ranks share each of its 2 KV heads), ``gemma-2b`` (MQA: every rank shares
the one KV head; GEGLU; a tied, scaled embedding), ``minicpm3-4b`` (MLA)
in this file; ``moonshot-v1-16b-a3b`` (experts and shared experts) and
``whisper-small`` (the encoder, cross-attention) in
``tests/test_torch_tp_more.py``.  Worlds ``(1, 2)``, ``(1, 4)``,
``(2, 2)`` (``data`` x ``model``).

Tolerances (float32 smoke configs; the split sums partial products
across ranks in another order than one device), each twice the largest
gap measured over the five architectures and three worlds:

- ``LOSS_TOL``: each step's loss within 3e-7 of its own magnitude
  (measured at most 1.46e-7, ``moonshot-v1-16b-a3b`` on ``(2, 2)``);
- ``NORM_TOL``: each step's gradient norm within 6.3e-7 (measured
  3.12e-7, ``moonshot-v1-16b-a3b`` on ``(1, 4)``);
- ``GRAD_TOL``: each gradient leaf within 3e-6 of its own largest |g|
  (measured 1.49e-6, ``minicpm3-4b``'s ``kv_norm``);
- ``PARAM_TOL``: after two steps, each parameter leaf within 2.3e-4 of
  its own largest |p| (measured 1.12e-4, ``whisper-small``'s ``w2`` on
  ``(1, 4)``: from a zero AdamW state a gradient element near 0 moves
  its parameter by up to a learning rate);
- ``OPT_TOL``: m and v, each leaf within 3.3e-5 of its own largest value
  (measured 1.61e-5, ``minicpm3-4b``'s ``wq_b`` on ``(1, 4)``);
- ``LOGIT_TOL``: the prefill's last logits within 1.6e-6 of the largest
  logit (measured 7.88e-7, ``moonshot-v1-16b-a3b`` on ``(1, 4)``).
"""
import dataclasses

import jax
import numpy as np
import pytest

import test_torch_world as W
import torch_mesh_cases as C
from repro import compat
from repro.configs import NO_SHARDING as R_NO_SHARDING
from repro.launch.mesh import make_local_mesh
from repro.models import model as RM
from repro_torch.configs import ShapeConfig, get_arch, smoke_of
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import MeshSpec
from repro_torch.launch.serve import serve_inputs
from repro_torch.launch.steps import input_specs
from repro_torch.models import params_from_numpy
from repro_torch.models.layers import flatten
from repro_torch.parallel.shard import RankMesh
from test_torch_lm_serve import check_tokens, margins
from test_torch_mesh_train import _reference_run
from test_torch_threads import one_torch_thread  # noqa: F401
from test_torch_train_parts import as_ref, configs, rel_err

LOSS_TOL = 3e-7
NORM_TOL = 6.3e-7
GRAD_TOL = 3e-6
PARAM_TOL = 2.3e-4
OPT_TOL = 3.3e-5
LOGIT_TOL = 1.6e-6
OPT = dict(peak_lr=1e-3, warmup_steps=2)
SERVE = dict(batch=4, prompt_len=16, gen=6, seed=0)
WORLDS = [(1, 2), (1, 4), (2, 2)]
AXES = ("data", "model")
ARCHS = ["qwen3-0.6b", "gemma-2b", "minicpm3-4b"]

_REF: dict = {}


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    w = W.World(2, tmp_path_factory.mktemp("tp2"))
    yield w
    w.close()


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    w = W.World(4, tmp_path_factory.mktemp("tp4"))
    yield w
    w.close()


def reference(name: str, over: dict | None = None) -> dict:
    """The reference's one-device runs of ``name`` (smoke, its fields
    ``over`` replaced), once per process: two train steps from its own
    parameters (``p0``, the ``batches``), ``loss_fn``'s gradients at
    ``p0`` on the first batch, and greedy serving on ``p0``: the prefill's
    last logits and the tokens."""
    key = (name, tuple(sorted((over or {}).items())))
    if key in _REF:
        return _REF[key]
    rcfg, cfg = configs(name)
    if over:
        rcfg = dataclasses.replace(rcfg, **over)
        cfg = dataclasses.replace(cfg, **over)
    p0, batches, run = _reference_run(name, 2, 4, 32, over=over)
    (_, _), grads = jax.jit(jax.value_and_grad(
        lambda p, b: RM.loss_fn(p, b, rcfg, R_NO_SHARDING),
        has_aux=True))(p0, as_ref(batches[0]))
    n = SERVE["prompt_len"]
    inp = {k: jax.numpy.asarray(v.numpy()) for k, v in serve_inputs(
        cfg, batch=SERVE["batch"], prompt_len=n, seed=SERVE["seed"],
        device="cpu").items()}
    prefill = jax.jit(lambda p, b: RM.prefill(p, b, rcfg, R_NO_SHARDING, n))
    step = jax.jit(lambda p, c, t: RM.decode_step(p, c, t, rcfg,
                                                  R_NO_SHARDING))
    with compat.set_mesh(make_local_mesh()):
        cache, logits = prefill(p0, inp)
        first = np.asarray(logits)
        toks = [np.asarray(logits[:, -1]).argmax(-1).astype(
            np.int32)[:, None]]
        for _ in range(SERVE["gen"] - 1):
            cache, logits = step(p0, cache, jax.numpy.asarray(toks[-1]))
            toks.append(np.asarray(logits[:, -1]).argmax(-1).astype(
                np.int32)[:, None])
    tokens = np.concatenate(toks, axis=1)
    _REF[key] = dict(p0=p0, batches=batches, run=run, logits=first,
                      tokens=tokens, grads=jax.tree.map(np.asarray, grads),
                      margin=margins(cfg, params_from_numpy(p0, "cpu"),
                                     tokens, batch=SERVE["batch"],
                                     prompt_len=n, seed=SERVE["seed"]))
    return _REF[key]


def _gap(got: list, want: list) -> float:
    return max(abs(a - b) / abs(b) for a, b in zip(got, want))


def _worst(got: dict, want: dict) -> tuple[float, str]:
    flat, ref = flatten(got), flatten(want)
    return max((rel_err(flat[k], ref[k]), k) for k in ref)


def check_split(world, name: str, shape, over: dict | None = None,
                tol: dict | None = None) -> list:
    """``name`` on ``shape``: every rank's results against the reference's
    one-device runs (``over``: smoke-config fields replaced; ``tol``:
    tolerances in place of this file's, by name: ``loss``, ``norm``,
    ``grads``, ``params``, ``m``, ``v``, ``logits``); the measured gaps
    as a line.  Returns the ranks' outputs."""
    tol = {**dict(loss=LOSS_TOL, norm=NORM_TOL, grads=GRAD_TOL,
                  params=PARAM_TOL, m=OPT_TOL, v=OPT_TOL, logits=LOGIT_TOL),
           **(tol or {})}
    ref = reference(name, over)
    outs = world.run(C.tp_run, shape, AXES, name, ref["p0"], ref["batches"],
                     OPT, SERVE, over)
    run = ref["run"]
    for got in outs:
        assert got["losses"] == outs[0]["losses"]
        gl = _gap(got["losses"], run["losses"])
        gn = _gap(got["grad_norms"], run["grad_norms"])
        assert gl <= tol["loss"], (name, shape, got["losses"], run["losses"])
        assert gn <= tol["norm"], (name, shape, got["grad_norms"],
                                   run["grad_norms"])
        worst = {"grads": _worst(got["grads"], ref["grads"])}
        for part in ("params", "m", "v"):
            worst[part] = _worst(got[part], run[part])
        for part in ("grads", "params", "m", "v"):
            assert worst[part][0] <= tol[part], (name, shape, part,
                                                 worst[part])
        le = rel_err(got["logits"], ref["logits"])
        assert le <= tol["logits"], (name, shape, "logits", le)
        check_tokens(got["tokens"], ref["tokens"], ref["margin"])
    line = (f"{name} {shape}: loss {gl:.2e} norm {gn:.2e} logits {le:.2e} "
            + " ".join(f"{k} {v[0]:.2e} ({v[1]})" for k, v in worst.items()))
    print(line)
    return outs


@pytest.mark.parametrize("shape", WORLDS, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", ARCHS)
def test_split_matches_the_reference(world2, world4, name, shape):
    check_split(world2 if np.prod(shape) == 2 else world4, name, shape)


def test_region_operators_and_the_head_group_gather(world4):
    """Each ``model`` rank r weights its share by r + 1: ``copy_to_model``
    sums the weights backward, ``reduce_from_model`` forward; a ``keep=2``
    gather holds the two blocks of a rank's pair and sums the pair's
    gradients (a reduce-scatter over the pair); ``keep=1`` holds the
    rank's own block and its own gradient."""
    whole = np.arange(16, dtype=np.float32).reshape(2, 8)
    for shape in ((1, 4), (2, 2)):
        for gx, z, g2, gw2, g1, gw1, coord in world4.run(C.tp_ops, shape,
                                                         AXES):
            m, r = shape[1], coord["model"]
            total = m * (m + 1) / 2
            np.testing.assert_array_equal(gx, np.full(3, total))
            np.testing.assert_array_equal(z, np.full(3, total))
            pair = r // 2 * 2 if m > 2 else 0
            cols = 8 // m
            np.testing.assert_array_equal(
                g2, whole[:, pair * cols:(pair + 2) * cols])
            np.testing.assert_array_equal(
                gw2, np.full((2, cols), (pair + 1) + (pair + 2),
                             np.float32))
            np.testing.assert_array_equal(
                g1, whole[:, r * cols:(r + 1) * cols])
            np.testing.assert_array_equal(gw1, np.full((2, cols), r + 1,
                                                       np.float32))


def _dry_flops(cfg, mesh_shape) -> float:
    rm = RankMesh.dry(MeshSpec(mesh_shape, AXES))
    fn, args = input_specs(cfg, ShapeConfig("t", "train", 64, 8), rm)
    return dryrun.measure(fn, args, rm)["flops"]


def test_split_step_flops_per_rank_are_at_most_half_of_one_rank():
    """Smoke ``qwen3-0.6b`` (4 heads, d_ff 256, vocabulary 512 all split
    over 4 ranks) on a dry ``(1, 4)`` mesh against ``(1, 1)``."""
    cfg = smoke_of(get_arch("qwen3-0.6b"))
    one, split = _dry_flops(cfg, (1, 1)), _dry_flops(cfg, (1, 4))
    assert split <= 0.5 * one, (split, one)
