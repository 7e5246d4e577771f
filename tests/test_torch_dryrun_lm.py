"""The LM dry run (``repro_torch.launch.steps.input_specs``,
``repro_torch.launch.dryrun``): every (architecture × shape) cell at smoke
size on a ``(2, 4)`` mesh runs on ``meta`` tensors only, with argument
bytes equal to the reference's per-device shard bytes under its own
``plan.spec``; ``dryrun_cell`` / ``main`` write the record's keys; the
dry mesh counts the collectives that a gloo ``(2, 4)`` run sends; and
with remat a sharded step holds about one layer's gathered weights.
"""
import dataclasses
import json

import numpy as np
import pytest
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as P

import test_torch_world as W
import torch_mesh_cases as C
from repro.configs import get_arch as r_get_arch
from repro.configs import smoke_of as r_smoke_of
from repro.configs.base import ShardingPlan as RPlan
from repro.launch import steps as RS
from repro.models import model as RM
from repro.models.layers import ParamDef as RParamDef
from repro.train.optimizer import OptConfig as ROptConfig
from repro.train.optimizer import opt_state_defs as r_opt_state_defs
from repro_torch.configs import (ShapeConfig, get_arch, list_archs,
                                 plan_for_mesh, smoke_of)
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import MeshSpec
from repro_torch.parallel.shard import RankMesh, local_shape
from repro_torch.launch.steps import input_specs, shardings_of
from repro_torch.models import param_defs
from test_torch_threads import one_torch_thread  # noqa: F401
from test_torch_train_parts import configs, ref_params

MESH = MeshSpec((2, 4), ("data", "model"))
SHAPES = {"train_s": ShapeConfig("train_s", "train", 64, 8),
          "prefill_s": ShapeConfig("prefill_s", "prefill", 64, 8),
          "decode_s": ShapeConfig("decode_s", "decode", 64, 8),
          "long_s": ShapeConfig("long_s", "decode", 128, 1)}
KEYS = {"arch", "shape", "mesh", "status", "reason", "n_chips", "seconds",
        "memory_analysis", "coll_count", "coll_bytes", "roofline",
        "model_flops_global", "model_flops_per_chip", "useful_flops_ratio"}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _ref_bytes(defs, plan, amesh) -> int:
    """Per-device bytes of a reference ``ParamDef`` table under its plan
    (a cache too: the port places it by ``plan.spec`` of every dim)."""
    n = 0
    for d in _leaves(defs):
        s = NamedSharding(amesh, P(*plan.spec(d.dims, d.shape)))
        n += int(np.prod(s.shard_shape(d.shape))) * np.dtype(
            "float32" if d.dtype == "float32" else
            "int32" if d.dtype == "int32" else "float16").itemsize
    return n


def _reference_arg_bytes(name: str, shape) -> int:
    rcfg = r_smoke_of(r_get_arch(name))
    plan = plan_for_mesh(MESH)
    rplan = RPlan(**{k: getattr(plan, k) for k in (
        "batch", "fsdp", "tp", "exp", "seq", "act_seq")},
        mesh_shape=dict(zip(MESH.axes, MESH.shape)))
    amesh = AbstractMesh(MESH.shape, MESH.axes)
    pdefs = RM.param_defs(rcfg)
    n = _ref_bytes(pdefs, rplan, amesh)
    if shape.kind == "train":
        n += _ref_bytes(r_opt_state_defs(
            pdefs, ROptConfig(state_dtype=rcfg.opt_state_dtype)), rplan, amesh)
    decode = shape.kind == "decode"
    n += _ref_bytes(RS.batch_defs(rcfg, shape, decode=decode), rplan, amesh)
    if decode:
        n += _ref_bytes(RM.cache_defs(rcfg, shape.global_batch,
                                      shape.seq_len), rplan, amesh)
    return n


@pytest.mark.parametrize("name", list_archs())
def test_every_cell_runs_on_meta_with_the_references_argument_bytes(name):
    cfg = smoke_of(get_arch(name))
    for shape in SHAPES.values():
        rm = RankMesh.dry(MESH)
        fn, args = input_specs(cfg, shape, rm)
        leaves = [t for a in args for t in _leaves(a)]
        assert leaves and all(t.is_meta for t in leaves)
        plan = plan_for_mesh(rm)
        pdefs = param_defs(cfg)
        for leaf, t in zip(_leaves(shardings_of(pdefs, rm, plan)),
                           _leaves(args[0])):
            assert local_shape(leaf.shape, leaf.spec, rm.sizes) == t.shape
        m = dryrun.measure(fn, args, rm)
        assert m["argument_size_in_bytes"] == _reference_arg_bytes(name,
                                                                    shape)
        assert m["total_per_device"] >= m["argument_size_in_bytes"] > 0
        assert m["flops"] > 0
        if shape.kind == "train":      # gathers forward, reductions back
            assert {"all-gather", "reduce-scatter", "all-reduce"} <= set(
                m["coll_count"])


@pytest.fixture
def small_cells(monkeypatch):
    """``dryrun_cell`` on smoke configs and the small shapes, with the
    reference's four shape names mapped onto them."""
    shapes = {k: dataclasses.replace(v, name=k) for k, v in zip(
        ("train_4k", "prefill_32k", "decode_32k", "long_500k"),
        SHAPES.values())}
    monkeypatch.setattr(dryrun, "get_arch", lambda n: smoke_of(get_arch(n)))
    monkeypatch.setattr(dryrun, "SHAPES", shapes)
    monkeypatch.setattr(dryrun.MeshSpec, "production",
                        classmethod(lambda cls, multi_pod=False: MESH))


def test_dryrun_cell_writes_the_records_keys(small_cells, tmp_path):
    rec = dryrun.dryrun_cell("moonshot-v1-16b-a3b", "train_4k",
                             multi_pod=False, out_dir=tmp_path)
    assert rec["status"] == "ok", rec
    assert KEYS <= set(rec), KEYS - set(rec)
    ma = rec["memory_analysis"]
    assert {"argument_size_in_bytes", "temp_size_in_bytes",
            "output_size_in_bytes", "total_per_device", "fits"} <= set(ma)
    assert ma["fits"] is True and rec["n_chips"] == 8
    assert {"compute_s", "memory_s", "collective_s", "bottleneck"} <= set(
        rec["roofline"])
    assert json.loads((tmp_path / "moonshot-v1-16b-a3b__train_4k__pod16x16"
                       ".json").read_text())["status"] == "ok"
    dec = dryrun.dryrun_cell("rwkv6-1.6b", "long_500k", multi_pod=False,
                             out_dir=tmp_path)
    assert dec["status"] == "ok" and dec["cache_seq_replicated"] is False
    skip = dryrun.dryrun_cell("qwen3-0.6b", "long_500k", multi_pod=False,
                              out_dir=tmp_path)
    assert skip["status"] == "skipped" and "512k" in skip["reason"]


def test_a_cell_past_its_limit_is_an_error(small_cells, tmp_path):
    rec = dryrun.dryrun_cell("qwen3-0.6b", "train_4k", multi_pod=False,
                             out_dir=tmp_path, limit_s=0.0)
    assert rec["status"] == "error" and "TimeoutError" in rec["error"]


def test_main_runs_lm_cells(small_cells, tmp_path, capsys):
    assert dryrun.main(["--arch", "qwen3-0.6b", "--shape", "decode_32k",
                        "--out", str(tmp_path)]) == 0
    assert "ok" in capsys.readouterr().out
    rec = json.loads((tmp_path / "qwen3-0.6b__decode_32k__pod16x16.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["cache_seq_replicated"] is False


def test_dry_collectives_are_what_a_gloo_run_sends(tmp_path):
    name = "moonshot-v1-16b-a3b"
    rcfg, _ = configs(name)
    from test_torch_train_parts import batch
    w = W.World(8, tmp_path)
    try:
        got = w.run(C.train, (2, 4), ("data", "model"), name,
                    ref_params(rcfg), [batch(rcfg, 4, 32)],
                    dict(peak_lr=1e-3, warmup_steps=2), None, True)
    finally:
        w.close()
    rm = RankMesh.dry(MESH)
    fn, args = input_specs(smoke_of(get_arch(name)),
                           ShapeConfig("t", "train", 32, 4), rm)
    m = dryrun.measure(fn, args, rm)
    for out in got:
        count, nbytes = out["coll"]
        assert count == m["coll_count"] and nbytes == m["coll_bytes"]


def _temp(cfg, n_layers: int) -> tuple[int, int]:
    """(peak live bytes less the arguments, one layer's whole weights) of a
    train step on an ``(8, 8)`` dry mesh."""
    cfg = dataclasses.replace(cfg, n_layers=n_layers)
    mesh = MeshSpec((8, 8), ("data", "model"))
    rm = RankMesh.dry(mesh)
    fn, args = input_specs(cfg, ShapeConfig("t", "train", 64, 8), rm)
    m = dryrun.measure(fn, args, rm)
    from repro_torch.models.model import block_defs, layer_runs
    layer = sum(int(np.prod(d.shape)) * 4 for d in _leaves(block_defs(
        layer_runs(cfg)[0][0], cfg, cfg.params_dtype)))
    return m["temp_size_in_bytes"], layer


def test_remat_keeps_about_one_layers_gathered_weights():
    """Each layer more adds its residual and its shards' gradients to the
    peak, not its whole weights: the gather runs inside the remat region,
    so its recompute gathers again."""
    cfg = smoke_of(get_arch("qwen3-0.6b"))
    assert cfg.remat
    t4, layer = _temp(cfg, 4)
    t8, _ = _temp(cfg, 8)
    assert (t8 - t4) / 4 < 0.5 * layer, (t4, t8, layer)
