"""The sub-quadratic blocks split along ``model`` (``models.ssm``: RWKV-6's
heads, its channel mix's hidden columns, Mamba's ``di`` channels) on gloo
worlds of CPU ranks, held to the reference's one-device step run live on
the same numpy inputs, as ``tests/test_torch_tp.py`` holds the attention
and MLP split: one train step's loss, gradient norm and every leaf's
gradient; the parameters and AdamW's m and v after two steps; the
prefill's logits and the greedy tokens (equal up to each row's first
near-tie).  Architectures: ``rwkv6-1.6b`` (smoke: d 128, so 2 heads of
64: split on ``model=2``, whole on ``model=4``, where its channel mix
still splits) and ``jamba-v0.1-52b`` (smoke: Mamba with ``di`` 256 at
layers 0, 1, 3-5, 7, attention at 2 and 6, MoE at the odd layers), on
``(1, 2)``, ``(1, 4)``, ``(2, 2)`` (``data`` x ``model``); and RWKV-6 at d
256 (4 heads) on ``(1, 4)``, where the time mix splits 4 ways.  This file
holds the RWKV-6 cases and the harness (``check``, ``TOL``);
``jamba-v0.1-52b``'s are in ``tests/test_torch_tp_jamba.py``.  Each
rank's cache leaves have the per-rank shapes of the reference's
``plan.spec`` (``NamedSharding.shard_shape`` on an ``AbstractMesh``).

Tolerances: ``tests/test_torch_tp.py``'s (3e-7 loss, 6.3e-7 gradient
norm, 3e-6 each leaf's gradient, 2.3e-4 parameters, 3.3e-5 m and v,
1.6e-6 prefill logits), except where an architecture measured more on
one of its worlds (CPU, gloo): that quantity gets twice the largest gap
it measured over its worlds, rounded up (``TOL``).  Those gaps are the
port's own against the reference, not the split's: on one rank, without
a split, the same comparison measures ``rwkv6-1.6b`` (its chunked scan's
exp(-cumsum) range) at gradient norm 7.7e-6, each leaf's gradient
7.5e-6, and ``jamba-v0.1-52b`` at each leaf's gradient 1.0e-5 and, after
two steps, ``log_a`` at 5.1e-3 of its largest value (initialised to
zero, so its scale is two learning rates, and an element with a
rounding-level gradient moves by a learning rate either way).  Measured:

- ``rwkv6-1.6b`` (three worlds, and d 256 on ``(1, 4)``): gradient norm
  1.401e-5 (``(1, 2)``), each leaf's gradient 8.283e-6 (``embed``),
  parameters 5.336e-4, m 6.467e-5, v 8.448e-5, logits 1.934e-6; the loss
  within 3e-7 (1.497e-7);
- ``jamba-v0.1-52b``: loss 5.807e-7, gradient norm 2.495e-6, each leaf's
  gradient 7.381e-6, parameters 8.598e-3 (``log_a``), m 1.078e-4, v
  1.710e-4, logits 1.985e-6.
"""
import numpy as np
import pytest
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as P

from repro.configs import get_arch as r_get_arch
from repro.configs import smoke_of as r_smoke_of
from repro.configs.base import ShardingPlan as RPlan
from repro.models import model as RM
from repro.models.layers import ParamDef as RParamDef
from repro_torch.configs import plan_for_mesh
from repro_torch.launch.mesh import MeshSpec
from test_torch_threads import one_torch_thread  # noqa: F401
from test_torch_tp import (AXES, SERVE, WORLDS, check_split, world2,  # noqa: F401
                           world4)

ARCHS = ["rwkv6-1.6b", "jamba-v0.1-52b"]
WIDE = dict(d_model=256)      # rwkv6 with 4 heads of 64
# what an architecture measured above tests/test_torch_tp.py's tolerances:
# twice its largest gap over its worlds, rounded up (see the docstring)
TOL = {"rwkv6-1.6b": dict(norm=2.9e-5, grads=1.7e-5, params=1.1e-3,
                          m=1.3e-4, v=1.7e-4, logits=3.9e-6),
       "jamba-v0.1-52b": dict(loss=1.2e-6, norm=5e-6, grads=1.5e-5,
                              params=1.8e-2, m=2.2e-4, v=3.5e-4,
                              logits=4e-6)}


def ref_cache_shapes(name: str, shape, over: dict | None = None) -> dict:
    """Per-rank shapes of the reference's cache leaves for ``SERVE``'s
    batch and prompt on a ``shape`` mesh (``plan.spec`` of every dim,
    ``NamedSharding.shard_shape``), by path."""
    import dataclasses
    spec = MeshSpec(tuple(shape), AXES)
    plan = plan_for_mesh(spec)
    rplan = RPlan(**{k: getattr(plan, k) for k in (
        "batch", "fsdp", "tp", "exp", "seq", "act_seq")},
        mesh_shape=dict(zip(spec.axes, spec.shape)))
    amesh = AbstractMesh(tuple(spec.shape), spec.axes)
    rcfg = dataclasses.replace(r_smoke_of(r_get_arch(name)), **(over or {}))
    out = {}

    def walk(tree, path):
        if isinstance(tree, RParamDef):
            s = NamedSharding(amesh, P(*rplan.spec(tree.dims, tree.shape)))
            out[path] = tuple(s.shard_shape(tree.shape))
            return
        for k, v in tree.items():
            walk(v, f"{path}/{k}" if path else k)
    walk(RM.cache_defs(rcfg, SERVE["batch"], SERVE["prompt_len"]), "")
    return out


def _flat(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}/{k}" if path else k))
        return out
    return {path: tuple(tree)}


def check(world, name, shape, over=None):
    outs = check_split(world, name, shape, over, TOL[name])
    want = ref_cache_shapes(name, shape, over)
    for got in outs:
        assert _flat(got["cache_shapes"]) == want, (name, shape)
    return want


@pytest.mark.parametrize("shape", WORLDS, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", ARCHS[:1])
def test_split_matches_the_reference(world2, world4, name, shape):
    want = check(world2 if np.prod(shape) == 2 else world4, name, shape)
    m = shape[1]
    # 2 heads of 64: split where m divides
    heads = [s for k, s in want.items() if k.endswith("mixer/state")]
    assert heads == [(4, 4 // shape[0], 2 // m if m == 2 else 2, 64,
                      64)], heads


def test_rwkv6_with_four_heads_splits_them_over_four_ranks(world4):
    want = check(world4, "rwkv6-1.6b", (1, 4), WIDE)
    assert [s for k, s in want.items() if k.endswith("mixer/state")] == [
        (4, 4, 1, 64, 64)]
