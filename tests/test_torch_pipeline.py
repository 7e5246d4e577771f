"""The port's coloring, recoloring and pipeline against the reference's.

Same graph, same partition, same keys: views, stats (``wire_bytes`` and
``n_exchanges`` included) and per-iteration histories must be equal bit for
bit (integer outputs, tolerance 0).  The reference runs live under
``jax_threefry_partitionable=True``, set explicitly.
"""
import jax
import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro_torch.core.graph import arrays_from_numpy, view_from_numpy
from test_torch_threads import one_torch_thread  # noqa: F401

SCHEMES = ["sparse", "allgather"]
SELECTIONS = ["first_fit", "random_x"]


@pytest.fixture(autouse=True)
def _partitionable():
    with jax.threefry_partitionable(True):
        yield


@pytest.fixture(scope="module")
def parts():
    """P -> (reference partition, port partition, visit order, graph)."""
    g_ref = R.rmat.rmat_good(10, 8, seed=3)
    g = T.rmat.rmat_good(10, 8, seed=3)
    cache = {}

    def get(P):
        if P not in cache:
            pr = R.partition_graph(g_ref, P)
            order = R.compute_order(pr, R.ordering.INTERNAL_FIRST)
            cache[P] = (pr, T.partition_graph(g, P), order, g)
        return cache[P]
    return get


def _valid(g, pg, view) -> bool:
    return T.check_coloring(g, T.colors_from_views(pg, view))["valid"]


def _pipeline_cfgs(sel, scheme, **kw):
    ref = R.PipelineConfig(
        color=R.ColorConfig(selection=sel, scheme=scheme),
        recolor=R.RecolorConfig(scheme=scheme), **kw)
    port = T.PipelineConfig(
        color=T.ColorConfig(selection=sel, scheme=scheme),
        recolor=T.RecolorConfig(scheme=scheme), **kw)
    return ref, port


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("sel", SELECTIONS)
def test_color_graph_sim_matches_reference(parts, sel, scheme):
    """P=4 here; P=2 is held by the pipeline test's color stats."""
    pr, pt, order, g = parts(4)
    vr, sr = R.color_graph_sim(pr, order,
                               R.ColorConfig(selection=sel, scheme=scheme))
    vt, st = T.color_graph_sim(pt, order,
                               T.ColorConfig(selection=sel, scheme=scheme),
                               device="cpu")
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vr))
    assert st == sr
    assert _valid(g, pt, vt)


@pytest.mark.parametrize("perm,scheme", [(R.RV, "sparse"), (R.NI, "sparse"),
                                         (R.ND, "sparse"), (R.ND, "allgather")])
def test_recolor_matches_reference(parts, perm, scheme):
    """One RC iteration on the reference's own partition and seed coloring,
    carried into the port by ``arrays_from_numpy``/``view_from_numpy``."""
    pr, pt, order, g = parts(4)
    seed_view, _ = R.color_graph_sim(
        pr, order, R.ColorConfig(selection="random_x", scheme=scheme))
    vr, sr = R.recolor_sim(pr, seed_view, perm, R.RecolorConfig(scheme=scheme),
                           key=jax.random.key(0))
    arrs = arrays_from_numpy(pr.arrays(sparse=scheme == "sparse"), "cpu")
    vt, st = T.recolor_shards(arrs, view_from_numpy(seed_view, "cpu"), perm,
                              T.RecolorConfig(scheme=scheme))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vr))
    assert st == sr
    assert st["n_colors_distinct"] <= st["n_colors_before"]
    vd, sd = T.recolor_sim(pt, view_from_numpy(seed_view, "cpu"), perm,
                           T.RecolorConfig(scheme=scheme), device="cpu")
    assert torch.equal(vd, vt) and sd == st
    assert _valid(g, pt, vt)


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("sel", SELECTIONS)
@pytest.mark.parametrize("P", [2, 4])
def test_pipeline_sim_matches_reference(parts, P, sel, scheme):
    pr, pt, order, g = parts(P)
    cfg_r, cfg_t = _pipeline_cfgs(sel, scheme, n_iters=3)
    vr, rr = R.pipeline_sim(pr, order, cfg_r)
    vt, rt = T.pipeline_sim(pt, order, cfg_t, device="cpu")
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vr))
    assert rt["color"] == rr["color"]
    assert T.color_graph_sim(pt, order, cfg_t.color, device="cpu")[1] == rr[
        "color"]
    assert rt["history"] == rr["history"]
    assert rt["n_iters_run"] == rr["n_iters_run"] == 3
    assert set(rt["seconds"]) == {"to_device", "color", "recolor"}
    assert _valid(g, pt, vt)


def test_adaptive_stop_matches_reference(parts):
    pr, pt, order, _ = parts(4)
    cfg_r, cfg_t = _pipeline_cfgs("first_fit", "sparse", n_iters=6,
                                  patience=1)
    vr, rr = R.pipeline_sim(pr, order, cfg_r)
    vt, rt = T.pipeline_sim(pt, order, cfg_t, device="cpu")
    assert rt["n_iters_run"] == rr["n_iters_run"] < 6
    assert rt["history"] == rr["history"]
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vr))


@pytest.mark.parametrize("preset", ["speed", "quality"])
def test_run_preset_matches_reference(parts, preset):
    pr, pt, _, _ = parts(2)
    make = lambda mod: (mod.presets.speed() if preset == "speed"
                        else mod.presets.quality(x=10, iters=2))
    vr, log_r = R.presets.run_preset(pr, make(R), seed=1)
    vt, log_t = T.presets.run_preset(pt, make(T), seed=1, device="cpu")
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vr))
    assert log_t == log_r


@pytest.mark.parametrize("entry", ["color", "recolor", "pipeline", "arc",
                                   "recolor_iterations", "recolor_loop"])
def test_entry_points_need_cuda_unless_asked_for_cpu(parts, monkeypatch,
                                                     entry):
    _, pt, order, _ = parts(2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    view = torch.zeros((2, pt.n_slots), dtype=torch.int32)
    calls = {
        "color": lambda: T.color_graph_sim(pt, order, T.ColorConfig()),
        "recolor": lambda: T.recolor_sim(pt, view, T.ND, T.RecolorConfig()),
        "pipeline": lambda: T.pipeline_sim(
            pt, order, T.PipelineConfig(color=T.ColorConfig())),
        "arc": lambda: T.arc_sim(pt, view, T.ND, T.RecolorConfig(),
                                 T.ColorConfig()),
        "recolor_iterations": lambda: T.recolor_iterations(
            pt, view, 2, T.RecolorConfig(), fused=False),
        "recolor_loop": lambda: T.recolor_loop_sim(
            pt, view, T.PipelineConfig(n_iters=2)),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()

