"""The LM on a mesh of gloo ranks: the port's counterpart of the
reference's ``tests/test_sharded_subprocess.py`` ``(2, 4)`` train step,
held to the reference's one-device step (GSPMD computes the same function
as one device, so this holds the plan's semantics without a multi-device
XLA run), at ``grad_accum`` 1 and 2, and a world of one rank against
the step without a mesh.  Serving, checkpoints and the ``Trainer`` on a
mesh are in ``tests/test_torch_mesh_state.py``.

Tolerances (float32 smoke configs; the sums run in another order: per-rank
partial sums, then a collective):

- ``LOSS_TOL``: each loss within 4e-7 of its own magnitude (measured at
  most 1.53e-7 over the four runs below: twice it, rounded up);
- ``NORM_TOL``: each step's gradient norm within 7e-7 of its own
  magnitude (measured at most 3.12e-7);
- ``PARAM_TOL``: after the steps, each parameter leaf within 1.6e-4 of
  its own largest |p| (measured at most 7.8e-5, the dense ``(2, 1)``
  run at ``grad_accum=2``; 5.0e-5 for the MoE on ``(2, 4)``: from a zero
  AdamW state a gradient element near 0 moves its parameter by up to a
  whole learning rate);
- ``OPT_TOL``: AdamW's m and v, each leaf within 2.6e-5 of its own
  largest value (measured at most 1.25e-5, the MoE on ``(2, 1)`` at
  ``grad_accum=2``).  The clip and m/sqrt(v) hide a gradient that is off
  by a constant factor per leaf from the parameters; m and v do not.
"""
import dataclasses
import jax
import numpy as np
import pytest

import test_torch_world as W
import torch_mesh_cases as C
from repro import compat
from repro.configs import NO_SHARDING as R_NO_SHARDING
from repro.launch import steps as RS
from repro.launch.mesh import make_local_mesh
from repro.train.optimizer import OptConfig as ROptConfig
from repro.train.optimizer import init_opt_state as r_init_opt_state
from repro_torch.configs import get_arch, plan_for_mesh, smoke_of
from repro_torch.launch.mesh import MeshSpec
from repro_torch.parallel.shard import local_shape
from repro_torch.models import param_defs
from repro_torch.models.layers import flatten
from test_torch_threads import one_torch_thread  # noqa: F401
from test_torch_train_parts import as_ref, batch, configs, rel_err, ref_params

LOSS_TOL = 4e-7
PARAM_TOL = 1.6e-4
NORM_TOL = 7e-7
OPT_TOL = 2.6e-5
OPT = dict(peak_lr=1e-3, warmup_steps=2)
MOE = "moonshot-v1-16b-a3b"


@pytest.fixture(scope="module")
def world8(tmp_path_factory):
    w = W.World(8, tmp_path_factory.mktemp("mesh8"))
    yield w
    w.close()


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    w = W.World(2, tmp_path_factory.mktemp("mesh2"))
    yield w
    w.close()


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    w = W.World(1, tmp_path_factory.mktemp("mesh1"))
    yield w
    w.close()


def _reference_run(name: str, steps: int, B: int, S: int, M: int = 1,
                   over: dict | None = None):
    """The reference's one-device ``make_train_step``, ``steps`` steps from
    its own initial parameters: (params0, batches, a dict of the
    ``losses`` and ``grad_norms`` of every step and the final ``params``,
    ``m`` and ``v``).  ``over``: smoke-config fields replaced."""
    rcfg, _ = configs(name)
    rcfg = dataclasses.replace(rcfg, grad_accum=M, **(over or {}))
    p = ref_params(rcfg)
    p0 = p
    opt_cfg = ROptConfig(**OPT)
    st = r_init_opt_state(p, opt_cfg)
    fn = jax.jit(RS.make_train_step(rcfg, R_NO_SHARDING, opt_cfg))
    batches = [batch(rcfg, B, S, step=s) for s in range(steps)]
    losses, norms = [], []
    with compat.set_mesh(make_local_mesh()):
        for b in batches:
            p, st, m = fn(p, st, as_ref(b))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return p0, batches, dict(losses=losses, grad_norms=norms,
                             params=tree(p), m=tree(st["m"]),
                             v=tree(st["v"]))


def _gap(got: list, want: list) -> float:
    return max(abs(a - b) / abs(b) for a, b in zip(got, want))


def _check_run(got, want, shape, what, name=MOE):
    """``got`` (a rank's ``C.train`` dict) against the reference's run:
    the gaps (losses, grad norms, params, m, v)."""
    gaps = (_gap(got["losses"], want["losses"]),
            _gap(got["grad_norms"], want["grad_norms"]))
    assert gaps[0] <= LOSS_TOL, (what, got["losses"], want["losses"])
    assert gaps[1] <= NORM_TOL, (what, got["grad_norms"], want["grad_norms"])
    assert got["losses"][-1] < got["losses"][0], got["losses"]
    worst = {}
    for part, tol in (("params", PARAM_TOL), ("m", OPT_TOL), ("v", OPT_TOL)):
        flat, ref = flatten(got[part]), flatten(want[part])
        worst[part] = max(rel_err(flat[k], ref[k]) for k in ref)
        assert worst[part] <= tol, (what, part, worst[part])
    # every rank holds only its shard of each parameter and of m
    spec = MeshSpec(tuple(shape), ("data", "model"))
    plan = plan_for_mesh(spec)
    defs = flatten(param_defs(smoke_of(get_arch(name))))
    ref = flatten(want["params"])
    split = 0
    for k, s in flatten(got["pshapes"]).items():
        g = ref[k].shape
        assert s == local_shape(g, plan.spec(defs[k].dims, g),
                                dict(zip(spec.axes, spec.shape))), (k, s)
        assert flatten(got["mshapes"])[k] == s
        split += s != g
    assert split > 0 or int(np.prod(shape)) == 1
    print(f"{what}: gaps loss {gaps[0]:.3e} grad_norm {gaps[1]:.3e} "
          + " ".join(f"{k} {v:.3e}" for k, v in worst.items()))
    return gaps, worst


def test_moe_train_step_on_2x4_matches_the_reference(world8):
    """The smoke MoE on ``(2, 4)``: six steps from the reference's initial
    parameters and ``host_batch`` stream (batch 4 x 32, the reference
    test's), against its one-device step."""
    p0, batches, want = _reference_run(MOE, 6, 4, 32)
    outs = world8.run(C.train, (2, 4), ("data", "model"), MOE, p0, batches,
                      OPT)
    for got in outs:
        # the same metrics everywhere
        assert got["losses"] == outs[0]["losses"]
        assert got["grad_norms"] == outs[0]["grad_norms"]
        _check_run(got, want, (2, 4), "moe 2x4")
    # the experts' shards: 8 experts over model, d_model over data
    ex = flatten(outs[0]["pshapes"])["run1/ffn/experts/w_gate"]
    assert ex == (3, 2, 64, 64)


@pytest.mark.parametrize("name,shape", [(MOE, (1, 2)),
                                        ("qwen3-0.6b", (2, 1)),
                                        (MOE, (2, 1))],
                         ids=["moe-model2", "dense-data2", "moe-data2"])
def test_grad_accum_2_on_two_ranks_matches_the_reference(world2, name, shape):
    """``grad_accum=2``: each rank's rows are its block of each of the two
    microbatches of the global batch (``device_batch``), so every
    microbatch holds the reference's rows, which the MoE's per-microbatch
    load-balance term depends on (``moe-data2``)."""
    p0, batches, want = _reference_run(name, 3, 4, 32, M=2)
    outs = world2.run(C.train, shape, ("data", "model"), name, p0, batches,
                      OPT, {"grad_accum": 2})
    for got in outs:
        _check_run(got, want, shape, f"{name} {shape} M=2", name)


def test_one_rank_is_bitwise_the_unsharded_step(world1):
    """A world of one rank (``(1, 1)``) against the step without a mesh."""
    rcfg, _ = configs("qwen3-0.6b")
    p0 = ref_params(rcfg)
    batches = [batch(rcfg, 4, 32, step=s) for s in range(2)]
    got = world1.run(C.train, (1, 1), ("data", "model"), "qwen3-0.6b", p0,
                     batches, OPT)[0]
    plain = C.train_plain("qwen3-0.6b", p0, batches, OPT)
    assert got["losses"] == plain[0]
    for k, v in flatten(plain[2]).items():
        np.testing.assert_array_equal(flatten(got["params"])[k], v, err_msg=k)
