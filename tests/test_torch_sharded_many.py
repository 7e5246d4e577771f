"""The port's ``color_many_sharded`` and its distance-2 runs on gloo worlds
of 4 and 2 ranks, against the reference's ``*_sim`` entry points run live.

``color_many_sharded`` on a 1D ``(4,)`` mesh (every rank holds one shard of
every lane) and on the 2D ``(1, 4)`` and ``(2, 2)`` coloring meshes (lanes
split over the batch axis, lane counts padded to it): every graph's view,
colors, color stats and history equal the reference's ``color_many`` bit
for bit, as ``tests/test_mesh2d.py`` pins the reference's own sharded
entry point.  At distance 2 (halo 2): ``pipeline_sharded`` against
``pipeline_sim`` and ``color_many_sharded`` against ``color_many`` on 2
ranks.  The reference runs under ``jax_threefry_partitionable=True``.
"""
import jax
import numpy as np
import pytest

import repro.core as R
import test_torch_world as W
from repro_torch.core.comm import AXIS, BATCH_AXIS

CASES = {
    # mesh spec, P, graphs: the reference's test_mesh2d cases
    "workers4": (((4,), (AXIS,)), 4,
                 [("rmat_good", (6, 8), 3), ("grid2d", (16, 16, 9), None)]),
    "coloring1x4": (((1, 4), (BATCH_AXIS, AXIS)), 4,
                    [("rmat_good", (6, 8), 3), ("grid2d", (16, 16, 9), None)]),
    "coloring2x2": (((2, 2), (BATCH_AXIS, AXIS)), 2,
                    [("rmat_er", (6, 8), s) for s in (1, 2, 3)]),
}
D2 = dict(max_colors=256, superstep=64, tile=16, distance=2)


@pytest.fixture(autouse=True)
def _partitionable():
    with jax.threefry_partitionable(True):
        yield


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    w = W.World(4, tmp_path_factory.mktemp("world4"))
    yield w
    w.close()


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    w = W.World(2, tmp_path_factory.mktemp("world2"))
    yield w
    w.close()


def _ref_graph(name, args, seed):
    return getattr(R.rmat, name)(*args, **({} if seed is None else
                                           dict(seed=seed)))


def _ref_cfg(color, recolor, pipe):
    return R.PipelineConfig(color=R.ColorConfig(**color),
                            recolor=R.RecolorConfig(**recolor), **pipe)


def _same_results(ref, got):
    assert len(ref) == len(got)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(b["view"], np.asarray(a["view"]))
        np.testing.assert_array_equal(b["colors"], np.asarray(a["colors"]))
        assert b["color"] == a["color"] and b["history"] == a["history"]
        assert b["n_iters_run"] == a["n_iters_run"]


@pytest.mark.parametrize("scheme", ["sparse", "allgather"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_color_many_sharded_matches_reference(world4, case, scheme):
    spec, P, g_specs = CASES[case]
    color = dict(max_colors=64, superstep=64, scheme=scheme)
    recolor = dict(max_colors=64, scheme=scheme)
    pipe = dict(n_iters=2, patience=1)
    pgs = [R.partition_graph(_ref_graph(*g), P) for g in g_specs]
    ref = R.color_many(pgs, _ref_cfg(color, recolor, pipe), pad_batch=True)
    for got in world4.run(W.many, spec, g_specs, P, 1, color, recolor, pipe,
                          True):
        _same_results(ref, got)


def test_pipeline_sharded_d2_matches_reference(world2):
    g_spec = ("grid2d", (12, 12, 9), None)
    pr = R.partition_graph(_ref_graph(*g_spec), 2, halo=2)
    order = R.compute_order(pr, R.ordering.NATURAL)
    color = dict(D2, selection="random_x", scheme="sparse")
    recolor = dict(max_colors=256, distance=2, scheme="sparse")
    pipe = dict(n_iters=3)
    vr, rr = R.pipeline_sim(pr, order, _ref_cfg(color, recolor, pipe))
    for view, res in world2.run(W.pipeline, ((2,), (AXIS,)), g_spec, 2, 2,
                                order, color, recolor, pipe):
        np.testing.assert_array_equal(view, np.asarray(vr))
        assert res == rr


def test_color_many_sharded_d2_matches_reference(world2):
    g_specs = [("grid2d", (12, 12, 9), None), ("grid3d", (6, 6, 6), None)]
    color = dict(D2, scheme="allgather")
    recolor = dict(max_colors=256, distance=2, scheme="allgather")
    pipe = dict(n_iters=2)
    pgs = [R.partition_graph(_ref_graph(*g), 2, halo=2) for g in g_specs]
    ref = R.color_many(pgs, _ref_cfg(color, recolor, pipe))
    for got in world2.run(W.many, ((1, 2), (BATCH_AXIS, AXIS)), g_specs, 2,
                          2, color, recolor, pipe, False):
        _same_results(ref, got)
