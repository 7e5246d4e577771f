"""The port's host substrate against the reference's, array for array, and
the port's independence from jax.

Graph generation, partitioning, the sparse comm plan and the visit orders
are numpy copies in ``repro_torch``; every array must equal the
reference's.  The port (and ``chip_smoke.py``) must import neither jax nor
``repro``.
"""
import ast
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import comm as ref_comm
from repro.core import graph as ref_graph
from repro.core import ordering as ref_ordering
from repro.core import rmat as ref_rmat
from repro_torch.core import comm, graph, ordering, rmat

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def graphs():
    return ref_rmat.rmat_good(10, 8, seed=3), rmat.rmat_good(10, 8, seed=3)


def _assert_same(a, b, what):
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert a == b, what


@pytest.mark.parametrize("gen", ["rmat_er", "rmat_good", "rmat_bad"])
def test_rmat_matches_reference(gen):
    a = getattr(ref_rmat, gen)(9, 8, seed=1)
    b = getattr(rmat, gen)(9, 8, seed=1)
    assert a.n == b.n
    _assert_same(a.indptr, b.indptr, "indptr")
    _assert_same(a.indices, b.indices, "indices")


@pytest.mark.parametrize("P", [1, 2, 4, 7])
def test_partition_and_plan_match_reference(graphs, P):
    g_ref, g = graphs
    a, b = ref_graph.partition_graph(g_ref, P), graph.partition_graph(g, P)
    for f in dataclasses.fields(b):
        _assert_same(getattr(a, f.name), getattr(b, f.name), f.name)
    pa, pb = a.comm_plan, b.comm_plan
    for f in dataclasses.fields(pb):
        _assert_same(getattr(pa, f.name), getattr(pb, f.name), f.name)
    for sparse in (True, False):
        da, db = a.arrays(sparse=sparse), b.arrays(sparse=sparse)
        assert da.keys() == db.keys()
        for k in da:
            _assert_same(da[k], db[k], k)
    for kind in ordering.ALL_ORDERINGS:
        _assert_same(ref_ordering.compute_order(a, kind),
                     ordering.compute_order(b, kind), kind)
    assert comm.resolve_scheme(comm.AUTO, b) == ref_comm.resolve_scheme(
        ref_comm.AUTO, a)


def test_device_state_carries_the_reference_partition(graphs):
    """``arrays_from_numpy`` takes the reference's ``arrays()`` dict and
    gives the port's own device dict; ``view_from_numpy`` a view."""
    g_ref, g = graphs
    a, b = ref_graph.partition_graph(g_ref, 4), graph.partition_graph(g, 4)
    carried = graph.arrays_from_numpy(a.arrays(), "cpu")
    own = graph.to_device(b, "cpu")
    assert carried.keys() == own.keys()
    for k in own:
        assert carried[k].dtype == own[k].dtype, k
        assert torch.equal(carried[k], own[k]), k
    view = np.arange(4 * b.n_slots, dtype=np.int32).reshape(4, b.n_slots)
    assert torch.equal(graph.view_from_numpy(view, "cpu"),
                       torch.from_numpy(view))


def _imported_modules(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_port_sources_import_neither_jax_nor_repro():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    port = {p.relative_to(REPO / "src" / "repro_torch").as_posix()
            for p in files}
    assert {"configs/base.py", "configs/archs.py", "models/layers.py",
            "models/attention.py", "models/moe.py", "models/ssm.py",
            "models/model.py", "models/convert.py",
            "launch/serve.py", "train/__init__.py", "train/optimizer.py",
            "train/checkpoint.py", "train/compression.py",
            "train/trainer.py", "data/pipeline.py", "launch/steps.py",
            "launch/train.py", "roofline.py", "parallel/shard.py",
            "launch/dryrun.py"} <= port
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        bad = _imported_modules(path) & {"jax", "jaxlib", "repro"}
        assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


def test_port_runs_with_jax_blocked():
    """With jax made unimportable, the port still imports, colors a
    small graph, serves a small LM, takes one training step of it on the
    CPU and sizes a sharded step of it on meta tensors."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        import repro_torch.core as core
        from repro_torch.core import presets
        g = core.rmat.rmat_good(8, 8, seed=1)
        pg = core.partition_graph(g, 2)
        order = core.compute_order(pg, core.ordering.INTERNAL_FIRST)
        cfg = presets.pipeline_config(presets.quality(x=5), n_iters=2)
        view, res = core.pipeline_sim(pg, order, cfg, device="cpu")
        st = core.check_coloring(g, core.colors_from_views(pg, view))
        assert st["valid"] and res["n_iters_run"] == 2, (st, res)
        from repro_torch.configs import get_arch, plan_for_mesh, smoke_of
        from repro_torch.launch.mesh import MeshSpec
        from repro_torch.launch.serve import serve
        toks, _ = serve(smoke_of(get_arch("minicpm3-4b")), None,
                        plan_for_mesh(MeshSpec.local()), batch=1,
                        prompt_len=8, gen=3, device="cpu")
        assert tuple(toks.shape) == (1, 3), toks.shape
        import torch
        from repro_torch.configs import NO_SHARDING
        from repro_torch.data.pipeline import DataConfig, host_batch
        from repro_torch.launch.steps import make_train_step
        from repro_torch.models import init_params, param_defs
        from repro_torch.train import OptConfig, init_opt_state
        arch = smoke_of(get_arch("qwen3-0.6b"))
        params = init_params(param_defs(arch), torch.Generator().manual_seed(0),
                             "cpu")
        opt = OptConfig(warmup_steps=1)
        b = {k: torch.from_numpy(v) for k, v in host_batch(DataConfig(
            arch.vocab_size, 16, 2), 0, arch).items()}
        new, st, m = make_train_step(arch, NO_SHARDING, opt)(
            params, init_opt_state(params, opt), b)
        assert int(st["count"]) == 1 and bool(torch.isfinite(m["loss"]))
        from repro_torch.configs import ShapeConfig
        from repro_torch.launch.dryrun import lm_record
        rec = lm_record(arch, ShapeConfig("t", "train", 16, 2),
                        MeshSpec((2, 1), ("data", "model")), 60)
        assert rec["status"] == "ok", rec
        assert "jax" not in {m.split(".")[0] for m in sys.modules
                             if sys.modules[m] is not None}
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(REPO / "src")))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
