"""The port's batched ``color_many`` against the reference's, lane by lane.

For every graph of a batch the port's ``color_many(..., device="cpu")``
must equal ``repro.core.color_many`` on the same inputs and keys, run
live under ``jax_threefry_partitionable=True`` (set explicitly): the
padded view, the global colors, the initial-coloring stats, the history
(``wire_bytes`` and ``n_exchanges`` included), ``n_iters_run`` and the
bucket index, bit for bit.  Each lane must also equal the port's own solo
``pipeline_sim`` of its padded member with the same keys.  The cases
mirror the reference's ``tests/test_serve.py``: across bucket boundaries
under both exchange schemes with Random-X and ND-RAND%2, distance 2 on
halo-2 grids and divergent adaptive stops; its fourth, dropped
``pad_batch`` lanes, is in ``test_torch_many_variants.py`` beside the
cases the reference file lacks.
"""
import numpy as np
import pytest
import torch

R = pytest.importorskip("repro.core")
jax = pytest.importorskip("jax")
import repro_torch.core as T  # noqa: E402
from repro_torch import rng  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402,F401

MC = 512


@pytest.fixture(autouse=True)
def _partitionable():
    with jax.threefry_partitionable(True):
        yield


def _port_key(k):
    return torch.from_numpy(
        np.asarray(jax.random.key_data(k)).astype(np.int64))


def one_bucket(M, pgs):
    """All of ``pgs`` padded to their widest dims, as one bucket."""
    dims = ("n_local_max", "max_ghost", "max_boundary", "m_local_max",
            "maxd", "maxd2")
    wide = {d: max(getattr(pg, d) for pg in pgs) for d in dims}
    return [M.GraphBucket(indices=tuple(range(len(pgs))), members=tuple(
        M.pad_partition(pg, **wide) for pg in pgs))]


def run_both(graphs, P, cfg, halo=1, together=False, **kw):
    """(port buckets, reference results, port results) of ``graphs`` (a
    function of the generator module) on P shards; ``cfg`` is a function
    of the package (``R`` or ``T``).  ``together`` puts every graph in one
    bucket (``one_bucket``) instead of ``bucket_graphs``' buckets."""
    pr = [R.partition_graph(g, P, halo=halo) for g in graphs(R)]
    pt = [T.partition_graph(g, P, halo=halo) for g in graphs(T)]
    br = one_bucket(R, pr) if together else R.bucket_graphs(pr)
    bt = one_bucket(T, pt) if together else T.bucket_graphs(pt)
    ref = R.color_many(pr, cfg(R), buckets=br, **kw)
    got = T.color_many(pt, cfg(T), buckets=bt, device="cpu", **kw)
    return bt, ref, got


def assert_lanes(buckets, cfg_t, ref, got, order_kind):
    """Every lane equals the reference's lane and the port's solo
    ``pipeline_sim`` of its padded member (the default folded keys, and
    the bucket's resolution of ``scheme="auto"``, made once for all its
    members from the union plan)."""
    for r, t in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(r["view"]), t["view"].numpy())
        np.testing.assert_array_equal(np.asarray(r["colors"]), t["colors"])
        assert t["color"] == r["color"]
        assert t["history"] == r["history"]
        assert t["n_iters_run"] == r["n_iters_run"]
        assert t["bucket"] == r["bucket"]
    for bucket in buckets:
        bcfg = T.bucket_signature(bucket, cfg_t).cfg
        for j, gi in enumerate(bucket.indices):
            m = bucket.members[j]
            ck = rng.fold_in(rng.key(cfg_t.color.seed), gi)
            rk = rng.fold_in(rng.key(cfg_t.seed), gi)
            v, solo = T.pipeline_sim(m, T.compute_order(m, order_kind), bcfg,
                                     color_key=ck, recolor_key=rk,
                                     device="cpu")
            assert torch.equal(got[gi]["view"], v)
            assert got[gi]["history"] == solo["history"]
            assert got[gi]["color"] == solo["color"]
            assert got[gi]["n_iters_run"] == solo["n_iters_run"]


def _mix(M):
    """Four small graphs that land in >= 2 shape buckets."""
    return [M.rmat.rmat_good(6, 8, seed=1), M.rmat.rmat_bad(6, 8, seed=2),
            M.rmat.rmat_good(8, 8, seed=3), M.rmat.grid2d(16, 16, 9)]


@pytest.mark.parametrize("P,scheme", [(4, "sparse"), (2, "allgather")])
def test_color_many_matches_reference_across_buckets(P, scheme):
    def cfg(M):
        return M.PipelineConfig(
            color=M.ColorConfig(max_colors=MC, superstep=64, scheme=scheme,
                                selection="random_x", random_x=10),
            recolor=M.RecolorConfig(max_colors=MC, scheme=scheme),
            n_iters=3, base_perm="nd", rand_every=2)
    bt, ref, got = run_both(_mix, P, cfg, orders=T.ordering.NATURAL)
    assert len(bt) >= 2                           # really spans buckets
    for g, t in zip(_mix(T), got):
        st = T.check_coloring(g, t["colors"])
        assert st["valid"], st
        assert st["n_colors"] == t["history"][-1]["n_colors_distinct"]
    assert_lanes(bt, cfg(T), ref, got, T.ordering.NATURAL)


def test_color_many_d2_two_hop_halo_matches_reference():
    def graphs(M):
        return [M.rmat.grid2d(12, 12, 9), M.rmat.grid2d(16, 12, 9)]

    def cfg(M):
        return M.PipelineConfig(
            color=M.ColorConfig(max_colors=MC, superstep=64, tile=16,
                                max_rounds=256, distance=2),
            recolor=M.RecolorConfig(max_colors=MC, distance=2), n_iters=2)
    bt, ref, got = run_both(graphs, 2, cfg, halo=2)
    for g, t in zip(graphs(T), got):
        assert T.check_coloring(g, t["colors"], distance=2)["valid"]
    assert_lanes(bt, cfg(T), ref, got, T.ordering.INTERNAL_FIRST)


def test_color_many_per_graph_adaptive_stop_matches_reference():
    """Lanes stop at different iterations; each stays its solo run."""
    def graphs(M):
        return [M.rmat.rmat_good(7, 8, seed=s) for s in (1, 2, 3, 4)]

    def cfg(M):
        return M.PipelineConfig(
            color=M.ColorConfig(max_colors=MC, superstep=64),
            recolor=M.RecolorConfig(max_colors=MC), n_iters=12,
            base_perm="nd", rand_every=2, patience=1)
    bt, ref, got = run_both(graphs, 4, cfg)
    iters = [t["n_iters_run"] for t in got]
    assert len(set(iters)) > 1                   # genuinely divergent stops
    assert all(it < 12 for it in iters)
    assert all(len(t["history"]) == it for t, it in zip(got, iters))
    # lanes of one batch stop at different iterations
    assert any(len({iters[i] for i in b.indices}) > 1 for b in bt)
    assert_lanes(bt, cfg(T), ref, got, T.ordering.INTERNAL_FIRST)
