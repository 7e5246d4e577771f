"""The once-a-step gather at ``grad_accum = M > 1``
(``launch.steps.make_train_step``): every non-expert leaf is all-gathered
over the batch axes once a step, before the first microbatch, as the
reference's ``train_step`` constrains it to its spec without the ``fsdp``
dim; the experts' leaves stay sharded and are gathered per layer in every
microbatch (forward and remat recompute).

- On a dry ``(2, 2)`` mesh at smoke size the step's all-gathers over
  ``data`` are counted at M = 1, 2 and 4: for the dense ``qwen3-0.6b``
  their count at M = 2 and 4 is one per leaf split over ``data`` (at
  M = 1 nothing changes: a layer gathers its leaves in the forward pass
  and again in the recompute, so the count is larger); for the MoE
  ``moonshot-v1-16b-a3b`` the non-expert part stays at that count and the
  experts' grows by a forward and a recompute gather of each of their
  three leaves in each MoE layer, per microbatch.
- The smoke MoE at ``grad_accum=2`` on a ``(2, 2)`` gloo world (the
  non-expert leaves gathered over ``data`` once a step while the experts
  stay split over ``model``), and the dense ``qwen3-0.6b`` on ``(1, 4)``
  (its KV heads shared by pairs of ``model`` ranks, whose columns a step
  gathers over the pair once too), held to the reference's one-device run
  at ``tests/test_torch_mesh_train.py``'s tolerances.
"""
import dataclasses

import pytest

import test_torch_world as W
import torch_mesh_cases as C
from repro_torch.configs import ShapeConfig, get_arch, plan_for_mesh, smoke_of
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import MeshSpec
from repro_torch.launch.steps import input_specs
from repro_torch.models import layer_runs, param_defs
from repro_torch.models.model import block_defs
from repro_torch.models.layers import flatten
from repro_torch.parallel.shard import ALL_GATHER, RankMesh, spec_axes
from test_torch_mesh_train import MOE, OPT, _check_run, _reference_run
from test_torch_threads import one_torch_thread  # noqa: F401

AXES = ("data", "model")


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    w = W.World(4, tmp_path_factory.mktemp("accum4"))
    yield w
    w.close()


def _data_gathers(name: str, M: int) -> int:
    """The all-gathers over ``data`` of one dry step of smoke ``name`` at
    ``grad_accum=M`` on ``(2, 2)`` (batch 8 x 64)."""
    cfg = dataclasses.replace(smoke_of(get_arch(name)), grad_accum=M)
    rm = RankMesh.dry(MeshSpec((2, 2), AXES))
    fn, args = input_specs(cfg, ShapeConfig("t", "train", 64, 8), rm)
    dryrun.measure(fn, args, rm)
    return sum(op == ALL_GATHER and ax == ("data",)
               for op, ax, _ in rm.log.calls)


def _split_over_data(d, plan) -> bool:
    return any("data" in spec_axes(e) for e in plan.spec(d.dims, d.shape))


def _expected(name: str) -> tuple[int, int]:
    """(the non-expert leaves that ``data`` splits: one gather each a step;
    the experts' gathers over ``data`` a microbatch: each such leaf of
    each MoE layer in the forward pass and in the recompute)."""
    cfg = smoke_of(get_arch(name))
    plan = plan_for_mesh(MeshSpec((2, 2), AXES))
    once = sum(_split_over_data(d, plan) and "exp" not in d.dims
               for d in flatten(param_defs(cfg)).values())
    per_micro = sum(2 * L for spec, L in layer_runs(cfg)
                    for d in flatten(block_defs(spec, cfg,
                                                cfg.params_dtype)).values()
                    if "exp" in d.dims and _split_over_data(d, plan))
    return once, per_micro


@pytest.mark.parametrize("name", ["qwen3-0.6b", MOE])
def test_non_expert_leaves_are_gathered_over_data_once_a_step(name):
    got = {M: _data_gathers(name, M) for M in (1, 2, 4)}
    once, per_micro = _expected(name)
    assert (per_micro > 0) == (name == MOE)
    for M in (2, 4):       # the non-expert part is the same at every M > 1
        assert got[M] - M * per_micro == once, (got, once, per_micro)
    # M = 1 is as before: every layer's leaves, forward and recompute
    assert got[1] - per_micro > once, (got, once, per_micro)


def test_moe_grad_accum_2_on_2x2_matches_the_reference(world4):
    p0, batches, want = _reference_run(MOE, 3, 4, 32, M=2)
    outs = world4.run(C.train, (2, 2), AXES, MOE, p0, batches, OPT,
                      {"grad_accum": 2})
    for got in outs:
        _check_run(got, want, (2, 2), f"{MOE} (2, 2) M=2")


def test_shared_kv_heads_at_grad_accum_2_on_1x4_match_the_reference(world4):
    """Smoke ``qwen3-0.6b`` (2 KV heads over 4 ``model`` ranks: each pair
    of ranks shares one, its ``wk`` / ``wv`` columns gathered over the
    pair) at ``grad_accum=2``: those columns are gathered over the pair
    once a step too, their gradients summed over it."""
    p0, batches, want = _reference_run("qwen3-0.6b", 3, 4, 32, M=2)
    outs = world4.run(C.train, (1, 4), AXES, "qwen3-0.6b", p0, batches, OPT,
                      {"grad_accum": 2})
    for got in outs:
        _check_run(got, want, (1, 4), "qwen3-0.6b (1, 4) M=2", "qwen3-0.6b")
