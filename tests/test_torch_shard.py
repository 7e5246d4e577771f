"""The port's per-rank shards (``repro_torch.parallel.shard``): spec tuples
and per-rank shapes against the reference's ``ShardingPlan.spec`` and
``NamedSharding.shard_shape`` for every leaf of the ten architectures,
``shard_of`` / ``unshard`` on gloo worlds (pod-major order included),
the gradient reductions of ``GatherLayer`` by kind of mesh axis, the
sharded global norm, and ``init_params_sharded`` on ``(2, 4)`` against
one rank.
"""
import numpy as np
import pytest
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as P

import test_torch_world as W
import torch_mesh_cases as C
from repro.configs import get_arch as r_get_arch
from repro.configs import list_archs as r_list_archs
from repro.configs.base import ShardingPlan as RPlan
from repro.models import model as RM
from repro.models.layers import ParamDef as RParamDef
from repro_torch.configs import get_arch, list_archs, plan_for_mesh, smoke_of
from repro_torch.launch.mesh import MeshSpec
from repro_torch.parallel.shard import ShardedLeaf, local_shape, spec_axes
from repro_torch.models import param_defs
from repro_torch.models.layers import flatten
from test_torch_threads import one_torch_thread  # noqa: F401

MESHES = [MeshSpec.production(), MeshSpec.production(multi_pod=True),
          MeshSpec((2, 4), ("data", "model"))]


def _ref_leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, RParamDef):
            out[path] = v
        else:
            out.update(_ref_leaves(v, path))
    return out


@pytest.mark.parametrize("spec", MESHES, ids=lambda s: "x".join(
    map(str, s.shape)))
def test_specs_and_local_shapes_are_the_references(spec):
    assert list_archs() == r_list_archs()
    plan = plan_for_mesh(spec)
    sizes = dict(zip(spec.axes, spec.shape))
    rplan = RPlan(**{k: getattr(plan, k) for k in (
        "batch", "fsdp", "tp", "exp", "seq", "act_seq")}, mesh_shape=sizes)
    amesh = AbstractMesh(tuple(spec.shape), tuple(spec.axes))
    n = 0
    for name in list_archs():
        ours = flatten(param_defs(get_arch(name)))
        ref = _ref_leaves(RM.param_defs(r_get_arch(name)))
        assert ours.keys() == ref.keys()
        for path, d in ours.items():
            rd = ref[path]
            s = plan.spec(d.dims, d.shape)
            rs = rplan.spec(rd.dims, rd.shape)
            assert s == tuple(rs), (name, path, s, rs)
            want = NamedSharding(amesh, P(*rs)).shard_shape(rd.shape)
            assert local_shape(d.shape, s, sizes) == tuple(want), (name, path)
            leaf = ShardedLeaf.of(d.shape, s, spec.axes)
            assert set(leaf.split) | set(leaf.replicated) == set(spec.axes)
            n += 1
    assert n > 400


@pytest.fixture(scope="module")
def world8(tmp_path_factory):
    w = W.World(8, tmp_path_factory.mktemp("shard8"))
    yield w
    w.close()


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    w = W.World(4, tmp_path_factory.mktemp("shard4"))
    yield w
    w.close()


def _arrays(seed=0):
    r = np.random.default_rng(seed)
    return {"a": r.normal(size=(8, 12)).astype(np.float32),
            "b": r.integers(0, 99, (4, 6, 8)).astype(np.int64),
            "c": r.normal(size=(16,)).astype(np.float32)}


def _expected_block(a, spec, sizes, coord):
    for dim, entry in enumerate(spec):
        axes = spec_axes(entry)
        if axes:
            i = 0
            for ax in axes:            # the first axis the most significant
                i = i * sizes[ax] + coord[ax]
            step = a.shape[dim] // int(np.prod([sizes[x] for x in axes]))
            a = np.take(a, range(i * step, (i + 1) * step), axis=dim)
    return a


@pytest.mark.parametrize("shape,axes,specs", [
    ((2, 2), ("data", "model"),
     {"a": ("model", "data"), "b": (None, "data", "model"), "c": (None,)}),
    ((2, 4), ("data", "model"),
     {"a": ("data", "model"), "b": ("data", None, "model"),
      "c": ("model",)}),
    ((2, 2, 2), ("pod", "data", "model"),
     {"a": (("pod", "data"), "model"), "b": ("model", None, ("pod", "data")),
      "c": (("pod", "data", "model"),)}),
], ids=["2x2", "2x4", "pod-major"])
def test_shard_of_then_unshard_is_the_identity(world4, world8, shape, axes,
                                               specs):
    world = world4 if np.prod(shape) == 4 else world8
    arrays = _arrays()
    sizes = dict(zip(axes, shape))
    outs = world.run(C.roundtrip, shape, axes, arrays, specs)
    coords = set()
    for back, blocks, coord in outs:
        coords.add(tuple(coord[a] for a in axes))
        for k, a in arrays.items():
            np.testing.assert_array_equal(back[k], a)
            np.testing.assert_array_equal(
                blocks[k], _expected_block(a, specs[k], sizes, coord))
            assert blocks[k].shape == local_shape(a.shape, specs[k], sizes)
    assert len(coords) == np.prod(shape)


def test_gradient_reductions_by_kind_of_axis(world8):
    """On ``(2, 4)``: each rank's loss is Σ W ⊙ X with X set by its data
    coordinate (batch ranks compute different rows, model ranks the
    same).  The shards' gradients must be the data ranks' mean of X,
    sliced like the leaf, for a leaf split over data, over model, over
    both, and replicated."""
    specs = {"fsdp": ("data", None), "tp": (None, "model"),
             "both": ("data", "model"), "rep": (None, None)}
    outs = world8.run(C.gather_grads, (2, 4), ("data", "model"), specs)
    X = [np.arange(64, dtype=np.float32).reshape(8, 8) * (d + 1)
         for d in range(2)]
    mean = (X[0] + X[1]) / 2
    sizes = {"data": 2, "model": 4}
    for grads, coord in outs:
        for k, sp in specs.items():
            np.testing.assert_allclose(
                grads[k], _expected_block(mean, sp, sizes, coord), rtol=1e-6)


def test_global_norm_counts_a_replicated_leaf_once(world8):
    got = world8.run(C.global_norm, (2, 4), ("data", "model"))
    r = np.random.default_rng(3)
    a = r.normal(size=(8, 8)).astype(np.float32)
    b = r.normal(size=(4,)).astype(np.float32)
    want = np.sqrt(np.sum(a.astype(np.float64) ** 2)
                   + np.sum(b.astype(np.float64) ** 2))
    for g in got:
        assert abs(g - want) <= 1e-6 * want


def test_init_params_sharded_gathers_to_the_one_rank_tree(world8,
                                                          tmp_path_factory):
    name = "moonshot-v1-16b-a3b"
    outs = world8.run(C.init_sharded, (2, 4), ("data", "model"), name, 0)
    one = W.World(1, tmp_path_factory.mktemp("one"))
    try:
        want, _ = one.run(C.init_sharded, (1, 1), ("data", "model"), name,
                          0)[0]
    finally:
        one.close()
    plan = plan_for_mesh(MeshSpec((2, 4), ("data", "model")))
    defs = flatten(param_defs(smoke_of(get_arch(name))))
    want = flatten(want)
    for tree, shapes in outs:
        tree, shapes = flatten(tree), flatten(shapes)
        assert tree.keys() == want.keys()
        for k in want:
            assert tree[k].dtype == want[k].dtype
            np.testing.assert_array_equal(tree[k], want[k], err_msg=k)
            d = defs[k]
            smoke = want[k].shape
            assert shapes[k] == local_shape(
                smoke, plan.spec(d.dims, smoke), {"data": 2, "model": 4}), k
    # the experts are split over model (exp) and their d_model over data
    assert flatten(outs[0][1])["run1/ffn/experts/w_gate"][1:] == (2, 64, 64)
