"""The port's LM configs and tables (``repro_torch.configs``,
``repro_torch.models`` parameter/cache tables, ``init_params``) against the
reference's: every field, count and table entry bitwise equal."""
import dataclasses
import types

import numpy as np
import pytest
import torch

import test_torch_world as W
from repro import configs as R
from repro.launch import mesh as RMesh
from repro.models import model as RM
from repro_torch import configs as P
from repro_torch.launch.mesh import MeshSpec
from repro_torch.models import layers as PL
from repro_torch.models import model as PM
from repro_torch.models import params_from_numpy
from test_torch_threads import one_torch_thread  # noqa: F401

ARCHS = R.list_archs()
# the reference's layouts, the coloring meshes and odd sizes that force
# the right-to-left drop
MESHES = [(spec.shape, spec.axes) for spec in (
    RMesh.MeshSpec.local(), RMesh.MeshSpec.production(),
    RMesh.MeshSpec.production(multi_pod=True), RMesh.MeshSpec.worker(8),
    RMesh.MeshSpec.coloring(4, batch=2))] + [
    ((2, 4), ("data", "model")), ((3, 8), ("data", "model")),
    ((4, 2, 6), ("pod", "data", "model")), ((5,), ("model",))]


def fake_mesh(shape, axes):
    """What the reference's plan_for_mesh reads of a jax mesh."""
    return types.SimpleNamespace(axis_names=axes, devices=np.empty(shape))


def test_the_same_registry_and_shapes():
    assert P.list_archs() == ARCHS
    assert P.SHAPES.keys() == R.SHAPES.keys()
    for k in R.SHAPES:
        assert dataclasses.asdict(P.SHAPES[k]) == dataclasses.asdict(
            R.SHAPES[k])
    for name in ARCHS:
        for shape in R.SHAPES:
            assert P.shape_applicable(P.get_arch(name), P.SHAPES[shape]) == \
                R.shape_applicable(R.get_arch(name), R.SHAPES[shape])
    with pytest.raises(KeyError):
        P.get_arch("no-such-arch")
    assert P.get_arch("qwen3-0.6b", n_layers=3) == dataclasses.replace(
        P.get_arch("qwen3_0_6b"), n_layers=3)


@pytest.mark.parametrize("name", ARCHS)
def test_arch_fields_counts_and_plans(name):
    for p, r in ((P.get_arch(name), R.get_arch(name)),
                 (P.smoke_of(P.get_arch(name)), R.smoke_of(R.get_arch(name)))):
        assert dataclasses.asdict(p) == dataclasses.asdict(r)
        assert (p.head_dim_, p.is_moe, p.vocab_padded(), p.vocab_padded(64)) \
            == (r.head_dim_, r.is_moe, r.vocab_padded(), r.vocab_padded(64))
        assert p.n_params() == r.n_params()
        assert p.n_active_params() == r.n_active_params()
        assert [dataclasses.astuple(s) for s in PM.layer_specs(p)] == \
            [dataclasses.astuple(s) for s in RM.layer_specs(r)]
        for pr, rr in ((PM.layer_runs(p), RM.layer_runs(r)),
                       (PM.encoder_runs(p), RM.encoder_runs(r))):
            assert [(dataclasses.astuple(s), n) for s, n in pr] == \
                [(dataclasses.astuple(s), n) for s, n in rr]


@pytest.mark.parametrize("name", ARCHS)
def test_param_and_cache_tables(name):
    for p, r in ((P.get_arch(name), R.get_arch(name)),
                 (P.smoke_of(P.get_arch(name)), R.smoke_of(R.get_arch(name)))):
        for got, want in ((PM.param_defs(p), RM.param_defs(r)),
                          (PM.cache_defs(p, 3, 40), RM.cache_defs(r, 3, 40))):
            g, w = PL.flatten(got), PL.flatten(want)
            assert g.keys() == w.keys()
            for k in w:
                assert dataclasses.asdict(g[k]) == dataclasses.asdict(w[k]), k
        assert PL.count_params(PM.param_defs(p)) == p.n_params()


@pytest.mark.parametrize("shape,axes", MESHES)
def test_plans_and_specs_match_the_reference(shape, axes):
    """``plan_for_mesh`` of the port's ``MeshSpec`` and ``spec`` over every
    parameter and cache table of every architecture equal the reference's
    plan of a mesh of that geometry and ``tuple(PartitionSpec)``."""
    got = P.plan_for_mesh(MeshSpec(shape, axes))
    want = R.plan_for_mesh(fake_mesh(shape, axes))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    seen = 0
    for name in ARCHS:
        pa, ra = P.get_arch(name), R.get_arch(name)
        for gd, wd in ((PM.param_defs(pa), RM.param_defs(ra)),
                       (PM.cache_defs(pa, 128, 32768),
                        RM.cache_defs(ra, 128, 32768)),
                       (PM.cache_defs(pa, 1, 524288),
                        RM.cache_defs(ra, 1, 524288))):
            g, w = PL.flatten(gd), PL.flatten(wd)
            for k, d in w.items():
                assert got.spec(g[k].dims, g[k].shape) == \
                    tuple(want.spec(d.dims, d.shape)), (name, k)
                assert got.spec(g[k].dims) == tuple(want.spec(d.dims))
                seen += 1
    assert seen > 800
    assert P.NO_SHARDING.spec(("batch", "tp", None)) == (None, None, None)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    w = W.World(2, tmp_path_factory.mktemp("lmplan"))
    yield w
    w.close()


def test_plan_for_a_built_device_mesh(world2):
    """``plan_for_mesh`` reads a built ``DeviceMesh`` (gloo ranks) as it
    reads its ``MeshSpec``."""
    shape, axes = (1, 2), ("data", "model")
    want = dataclasses.asdict(R.plan_for_mesh(fake_mesh(shape, axes)))
    assert world2.run(W.lm_plan, shape, axes) == [want, want]


def test_init_params_follows_its_table_and_seed():
    cfg = P.smoke_of(P.get_arch("moonshot-v1-16b-a3b"))
    defs = PM.param_defs(cfg)
    a = PL.init_params(defs, torch.Generator().manual_seed(7), "cpu")
    b = PL.init_params(PL.flatten(defs), torch.Generator().manual_seed(7))
    c = PL.init_params(defs, torch.Generator().manual_seed(8), "cpu")
    fa, fb, fc, fd = (PL.flatten(t) for t in (a, b, c, defs))
    assert fa.keys() == fd.keys() == fb.keys()
    for k, d in fd.items():
        t = fa[k]
        assert tuple(t.shape) == d.shape and t.dtype == PL.DTYPES[d.dtype], k
        assert torch.equal(t, fb[k]), k
        if d.init == "zeros":
            assert not t.any(), k
        elif d.init == "ones":
            assert (t == 1).all(), k
        else:
            assert not torch.equal(t, fc[k]), k
            scale = d.scale if d.scale is not None else \
                (d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]) ** -0.5
            assert abs(float(t.float().std()) / scale - 1) < 0.1, k
    # one draw per path: two tables of one shape get different values
    assert not torch.equal(fa["run1/ffn/experts/w_gate"],
                           fa["run1/ffn/experts/w_up"])
    bf = PL.init_params({"w": PL.ParamDef((64, 32), (None, None))},
                        torch.Generator().manual_seed(0))["w"]
    assert bf.dtype == torch.bfloat16


def test_params_from_numpy_keeps_paths_values_and_dtypes():
    import jax.numpy as jnp
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
            "b": {"c": np.asarray(jnp.asarray([1.5, -2.25], jnp.bfloat16)),
                  "pos": np.int32(4)}}
    got = params_from_numpy(tree, "cpu")
    assert got["a"].dtype == torch.float32
    assert torch.equal(got["a"], torch.arange(6.0).reshape(2, 3))
    assert got["b"]["c"].dtype == torch.bfloat16
    assert got["b"]["c"].tolist() == [1.5, -2.25]
    assert got["b"]["pos"].dtype == torch.int32 and int(got["b"]["pos"]) == 4
    cast = params_from_numpy(tree, "cpu", dtype=torch.bfloat16)
    assert cast["a"].dtype == torch.bfloat16
    assert cast["b"]["pos"].dtype == torch.int32
