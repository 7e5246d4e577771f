"""The port's three examples (``examples/torch_*.py``) on the CPU at small
sizes, against the reference API's same calls run live.

Each example's ``main`` takes the same steps as its reference example
through ``repro_torch``; its colorings and stats must be bitwise what
the reference's entry points give for the same calls (the reference
under ``jax_threefry_partitionable=True``, set explicitly as the parity
tests do).  The distributed example also runs on a 2-rank gloo world,
where its ``color_graph_sharded`` must give the reference's
``color_graph_sim`` coloring and stats.
"""
import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest

import repro.core as R
import test_torch_world as W
from repro.data import coloring_sched as RS
from test_torch_threads import one_torch_thread  # noqa: F401

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"


@pytest.fixture(autouse=True)
def _partitionable():
    with jax.threefry_partitionable(True):
        yield


def load(name: str):
    spec = importlib.util.spec_from_file_location(name,
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_matches_the_reference():
    got = load("torch_quickstart").main(device="cpu", scale=9, P=4)
    g = R.rmat.rmat_good(9, 8, seed=1)
    pg = R.partition_graph(g, 4)
    preset = R.presets.quality(x=10)
    cfg = R.presets.pipeline_config(preset, n_iters=5, patience=2)
    view, res = R.pipeline_sim(pg, R.compute_order(pg, preset.ordering), cfg)
    colors = R.colors_from_views(pg, np.asarray(view))
    np.testing.assert_array_equal(got["colors"], colors)
    for k in ("color", "history", "n_iters_run"):
        assert got["result"][k] == res[k], k
    ref_check = R.check_coloring(g, colors)
    assert got["check"].keys() == ref_check.keys()
    for k, v in ref_check.items():
        np.testing.assert_array_equal(got["check"][k], v)
    assert got["check"]["valid"]


def _same_groups(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_coloring_sched_matches_the_reference():
    got = load("torch_coloring_sched").main(device="cpu", n_samples=64,
                                            n_batches=3)
    groups, n_groups, log = RS.schedule(got["rows"], 64, n_workers=4)
    g_groups, g_n, g_log = got["single"]
    _same_groups(g_groups, groups)
    assert (g_n, g_log) == (n_groups, log)
    ref = RS.schedule_many(got["batches"], 64, n_workers=4, n_iters=1)
    assert len(got["many"]) == len(ref) == 3
    for (gg, gn, gs), (rg, rn, rs) in zip(got["many"], ref):
        _same_groups(gg, rg)
        assert gn == rn
        assert gs == {k: rs[k] for k in ("color", "history", "bucket")}


def _ref_presets(scale: int, P: int) -> dict:
    g = R.rmat.rmat_er(scale, 8, seed=1)
    pg = R.partition_graph(g, P)
    out = {}
    for preset in (R.presets.speed(), R.presets.quality(x=10)):
        view, log = R.presets.run_preset(pg, preset)
        out[preset.name] = (R.colors_from_views(pg, np.asarray(view)), log)
    return out


def test_distributed_coloring_presets_match_the_reference(capsys):
    got = load("torch_distributed_coloring").main(device="cpu", scale=9, P=4)
    assert "torchrun --nproc-per-node=N" in capsys.readouterr().out
    assert "sharded" not in got
    for name, (colors, log) in _ref_presets(9, 4).items():
        np.testing.assert_array_equal(got[name][0], colors)
        assert got[name][1] == log


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    w = W.World(2, tmp_path_factory.mktemp("examples2"))
    yield w
    w.close()


def test_distributed_coloring_on_a_gloo_world(world2):
    outs = world2.run(W.example, "torch_distributed_coloring",
                      dict(device="cpu", scale=9, P=4))
    g = R.rmat.rmat_er(9, 8, seed=1)
    pg = R.partition_graph(g, 2)
    view, stats = R.color_graph_sim(
        pg, R.compute_order(pg, R.ordering.INTERNAL_FIRST),
        R.ColorConfig(max_colors=1024, superstep=512))
    colors = R.colors_from_views(pg, np.asarray(view))
    ref_presets = _ref_presets(9, 4)
    for out in outs:
        np.testing.assert_array_equal(out["sharded"][0], colors)
        assert out["sharded"][1] == stats
        for name, (c, log) in ref_presets.items():
            np.testing.assert_array_equal(out[name][0], c)
            assert out[name][1] == log


def test_serve_decode_example_on_the_cpu(capsys):
    """The port's ``serve_decode`` example: the reference example's two
    serves (its weights are the port's own seeded draw, so the tokens are
    held in range and in shape here; ``tests/test_torch_lm_serve.py`` holds
    serve to the reference on carried weights)."""
    got = load("torch_serve_decode").main(device="cpu")
    out = capsys.readouterr().out
    assert "generated: (4, 24)" in out and "MLA absorbed decode" in out
    for key, shape, vocab in (("qwen3", (4, 24), 512),
                              ("minicpm3", (2, 8), 512)):
        tokens, stats = got[key]
        assert tuple(tokens.shape) == shape
        assert int(tokens.min()) >= 0 and int(tokens.max()) < vocab
        assert stats["tok_per_s"] > 0


def test_train_lm_example_on_the_cpu(capsys):
    """The port's ``train_lm`` example at ``tiny=True``: it survives its
    injected failure and its loss falls (its weights are the port's own
    seeded draw; ``tests/test_torch_trainer.py`` holds the trainer to the
    reference)."""
    tr = load("torch_train_lm").main(device="cpu", steps=30, tiny=True)
    out = capsys.readouterr().out
    assert "survived 1 injected failure(s)" in out
    assert tr.restarts == 1 and tr.injector.fired == [15]
    losses = [h["loss"] for h in tr.history]
    assert losses[-1] < losses[0] and all(np.isfinite(losses))
