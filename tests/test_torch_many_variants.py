"""``color_many`` cases beyond the reference's own tests, each lane held to
the reference's ``color_many`` (run live under
``jax_threefry_partitionable=True``) and to the port's solo
``pipeline_sim`` of its padded member, bit for bit (``test_torch_many``'s
checks): dropped ``pad_batch`` lanes (the reference's fourth case), a
sequential bucket (First Fit with ``parallel_chunk=False`` and
Least-Used, the batched ``greedy_run``), Staggered First Fit (the start
color from the shard's index within its lane), a batch cut by
``max_rounds=1`` with uncolored vertices left in some lanes and not in
others, and ``data.coloring_sched.schedule_many`` against the
reference's.
"""
import numpy as np
import pytest
import torch

R = pytest.importorskip("repro.core")
jax = pytest.importorskip("jax")
from test_torch_many import assert_lanes, run_both  # noqa: E402

import repro_torch.core as T  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402,F401

MC = 256


@pytest.fixture(autouse=True)
def _partitionable():
    with jax.threefry_partitionable(True):
        yield


def _trio(M):
    return [M.rmat.rmat_good(6, 8, seed=4), M.rmat.rmat_bad(6, 8, seed=5),
            M.rmat.grid2d(12, 12, 9)]


@pytest.mark.parametrize("selection", ["first_fit", "least_used"])
def test_color_many_sequential_bucket_matches_reference(selection):
    def cfg(M):
        return M.PipelineConfig(
            color=M.ColorConfig(max_colors=MC, superstep=16,
                                selection=selection, parallel_chunk=False),
            recolor=M.RecolorConfig(max_colors=MC), n_iters=2)
    bt, ref, got = run_both(_trio, 2, cfg, together=True)
    for g, t in zip(_trio(T), got):
        assert T.check_coloring(g, t["colors"])["valid"]
    assert_lanes(bt, cfg(T), ref, got, T.ordering.INTERNAL_FIRST)


def test_color_many_staggered_matches_reference():
    def cfg(M):
        return M.PipelineConfig(
            color=M.ColorConfig(max_colors=MC, superstep=32,
                                selection="staggered", stagger_estimate=24,
                                scheme="sparse"),
            recolor=M.RecolorConfig(max_colors=MC, scheme="sparse"),
            n_iters=1)
    bt, ref, got = run_both(_trio, 4, cfg, together=True)
    # shards of a lane start at different colors
    assert all(t["color"]["n_colors"] > 24 for t in got)
    assert_lanes(bt, cfg(T), ref, got, T.ordering.INTERNAL_FIRST)


def _halves(M, n=128):
    """Two paths, one per shard at P=2: no cross-shard edge, so one-vertex
    tiles color them without a conflict."""
    src = np.array([i for i in range(n - 1) if i != n // 2 - 1], np.int32)
    return M.rmat._edges_to_graph(n, src, src + 1)


def test_color_many_max_rounds_cut_matches_reference():
    """``max_rounds=1`` with one-vertex tiles: the lanes whose shards
    share edges stop with the losers of round 0 uncolored, the two-path
    lane finished; the recolor loop goes on for all of them."""
    def graphs(M):
        return [M.rmat.rmat_good(7, 8, seed=6), _halves(M),
                M.rmat.grid2d(12, 10, 5)]

    def cfg(M):
        return M.PipelineConfig(
            color=M.ColorConfig(max_colors=MC, superstep=64, tile=1,
                                max_rounds=1),
            recolor=M.RecolorConfig(max_colors=MC), n_iters=2)
    bt, ref, got = run_both(graphs, 2, cfg, together=True)
    left = [int((t["colors"] == 0).sum()) for t in got]
    assert left[1] == 0 and min(left[0], left[2]) > 0, left
    assert all(t["color"]["n_rounds"] == 1 for t in got)
    assert_lanes(bt, cfg(T), ref, got, T.ordering.INTERNAL_FIRST)


def test_schedule_many_matches_reference():
    from repro.data import coloring_sched as r_sched

    from repro_torch.data import coloring_sched as t_sched
    gen = np.random.default_rng(0)
    batches = [gen.integers(0, 24 + 8 * (i % 3), (48, 3)) for i in range(5)]
    want = r_sched.schedule_many(batches, 48, n_workers=2)
    got = t_sched.schedule_many(batches, 48, n_workers=2, device="cpu")
    assert len({stats["bucket"] for _, _, stats in got}) >= 2
    for (gr, nr, sr), (gt, nt, st), res in zip(want, got, batches):
        assert nt == nr and st == sr
        assert len(gt) == len(gr)
        for a, b in zip(gr, gt):
            np.testing.assert_array_equal(a, b)
        assert t_sched.validate_schedule(res, gt)
    g = t_sched.conflict_graph(batches[0], 48)
    r = r_sched.conflict_graph(batches[0], 48)
    np.testing.assert_array_equal(g.indptr, r.indptr)
    np.testing.assert_array_equal(g.indices, r.indices)


def test_color_many_pad_batch_lanes_dropped():
    """Power-of-two lane padding (3 graphs -> 4 lanes) changes nothing."""
    def graphs(M):
        return [M.rmat.rmat_good(6, 8, seed=s) for s in (1, 2, 3)]

    def cfg(M):
        return M.PipelineConfig(color=M.ColorConfig(max_colors=MC,
                                                    superstep=64),
                                recolor=M.RecolorConfig(max_colors=MC),
                                n_iters=2)
    bt, ref, got = run_both(graphs, 2, cfg, pad_batch=True)
    assert [b.B for b in bt] == [3]
    plain = T.color_many([m for b in bt for m in b.members], cfg(T),
                         buckets=bt, device="cpu")
    for x, y in zip(plain, got):
        assert torch.equal(x["view"], y["view"])
        np.testing.assert_array_equal(x["colors"], y["colors"])
        assert x["history"] == y["history"] and x["color"] == y["color"]
    assert_lanes(bt, cfg(T), ref, got, T.ordering.INTERNAL_FIRST)
