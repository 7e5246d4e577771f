"""The port's shape buckets and numpy pieces against the reference's.

``pad_partition``, ``bucket_graphs`` (indices, members, stacked arrays,
union schedule), ``remap_plan_arrays``, ``plan_fits`` and the
``plan_signature``/``bucket_signature`` fields (all but ``cfg`` and
``extra``) are held array by array, field by field, to ``repro.core`` at
halo 1 and halo 2; then the numpy satellites: ``rmat.random_regular_ish``,
``rmat.geometric``, ``SUITE_REAL``/``SUITE_RMAT``, ``assert_valid``,
``message_stats``, ``IdPolicy``/``check_int32_limits``.  Everything is
numpy, bitwise (tolerance 0).  The program-cache counters and the
bucket's device-array cache are checked on the port alone.
"""
import dataclasses

import numpy as np
import pytest

import repro_torch.core as T

R = pytest.importorskip("repro.core")
jax = pytest.importorskip("jax")


@pytest.fixture(autouse=True)
def _partitionable():
    with jax.threefry_partitionable(True):
        yield


MC = 256


def _graphs(M, halo):
    if halo == 1:
        return [M.rmat.rmat_good(6, 8, seed=1), M.rmat.rmat_bad(6, 8, seed=2),
                M.rmat.rmat_good(8, 8, seed=3), M.rmat.grid2d(16, 16, 9)]
    return [M.rmat.grid2d(12, 12, 9), M.rmat.grid2d(16, 12, 9),
            M.rmat.grid3d(5, 5, 4)]


def _parts(halo, P):
    return ([R.partition_graph(g, P, halo=halo) for g in _graphs(R, halo)],
            [T.partition_graph(g, P, halo=halo) for g in _graphs(T, halo)])


FIELDS = ("P", "n_global", "n_local_max", "max_ghost", "max_boundary",
          "m_local_max", "maxd", "offs", "n_local", "n_ghost", "n_boundary",
          "indptr", "indices", "nbr", "edge_src", "boundary", "ghost_owner",
          "ghost_slot", "gvid", "prio", "is_internal", "degree", "halo",
          "maxd2", "nbr2")


def _assert_pg_equal(a, b):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        if x is None or y is None:
            assert x is None and y is None, f
        else:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                          err_msg=f)
            assert np.asarray(x).dtype == np.asarray(y).dtype, f


def _assert_dicts_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k


@pytest.mark.parametrize("halo", [1, 2])
def test_pad_partition_matches_reference(halo):
    rs, ts = _parts(halo, 4)
    for r, t in zip(rs, ts):
        wide = dict(n_local_max=t.n_local_max + 7,
                    max_ghost=t.max_ghost + 3,
                    max_boundary=t.max_boundary + 2,
                    m_local_max=t.m_local_max + 11, maxd=t.maxd + 5)
        if halo == 2:
            wide["maxd2"] = t.maxd2 + 4
        pr, pt = R.pad_partition(r, **wide), T.pad_partition(t, **wide)
        _assert_pg_equal(pr, pt)
        _assert_dicts_equal(pr.arrays(), pt.arrays())
        assert pr.comm_plan.static == pt.comm_plan.static
        assert T.pad_partition(t) is t                 # no-op fast path
    with pytest.raises(ValueError):
        T.pad_partition(ts[0], maxd=ts[0].maxd - 1)


@pytest.mark.parametrize("round_pow2", [True, False])
@pytest.mark.parametrize("halo", [1, 2])
def test_bucket_graphs_matches_reference(halo, round_pow2):
    rs, ts = _parts(halo, 4)
    br = R.bucket_graphs(rs, round_pow2=round_pow2)
    bt = T.bucket_graphs(ts, round_pow2=round_pow2)
    assert [b.indices for b in br] == [b.indices for b in bt]
    assert sorted(i for b in bt for i in b.indices) == list(range(len(ts)))
    for a, b in zip(br, bt):
        assert (a.B, a.P) == (b.B, b.P)
        for ma, mb in zip(a.members, b.members):
            _assert_pg_equal(ma, mb)
        assert a.plan_static == b.plan_static
        for j in range(a.B):
            _assert_dicts_equal(a.member_arrays(j), b.member_arrays(j))
        for sparse in (True, False):
            _assert_dicts_equal(a.stacked_arrays(sparse=sparse),
                                b.stacked_arrays(sparse=sparse))
    if halo == 1 and round_pow2:
        assert len(bt) >= 2                          # really spans buckets


@pytest.mark.parametrize("halo", [1, 2])
def test_union_plan_and_remap_match_reference(halo):
    from repro.core.graph import _union_comm_arrays as r_union

    from repro_torch.core.graph import _union_comm_arrays as t_union
    rs, ts = _parts(halo, 4)
    # pad every member to one shape so the union covers them all
    wide = {d: max(getattr(t, d) for t in ts) for d in (
        "n_local_max", "max_ghost", "max_boundary", "m_local_max", "maxd",
        "maxd2")}
    mr = [R.pad_partition(r, **wide) for r in rs]
    mt = [T.pad_partition(t, **wide) for t in ts]
    (sr, ar), (st, at) = r_union(mr), t_union(mt)
    assert sr == st
    for a, b in zip(ar, at):
        _assert_dicts_equal(a, b)
    for r, t in zip(mr, mt):
        assert R.plan_fits(r.comm_plan, sr) == T.plan_fits(t.comm_plan, st)
        assert T.plan_fits(t.comm_plan, st)
        _assert_dicts_equal(R.remap_plan_arrays(r, sr),
                            T.remap_plan_arrays(t, st))
        # a member's own plan: its own arrays with exact round widths
        own = t.comm_plan.static
        _assert_dicts_equal(R.remap_plan_arrays(r, own),
                            T.remap_plan_arrays(t, own))
    # a schedule that lacks a shift, or narrows a width, does not fit
    shifts, widths = mt[0].comm_plan.static
    for bad in ((shifts[1:], widths[1:]),
                (shifts, (max(widths[0] // 2, 0),) + widths[1:])):
        want = R.plan_fits(mr[0].comm_plan, bad)
        assert T.plan_fits(mt[0].comm_plan, bad) == want
        if not want:
            with pytest.raises(ValueError):
                T.remap_plan_arrays(mt[0], bad)


def _cfgs(scheme, distance):
    def cfg(M):
        return M.PipelineConfig(
            color=M.ColorConfig(max_colors=MC, superstep=64, scheme=scheme,
                                distance=distance),
            recolor=M.RecolorConfig(max_colors=MC, scheme=scheme,
                                    distance=distance), n_iters=2)
    return cfg(R), cfg(T)


SIG_FIELDS = ("kind", "P", "n_local_max", "maxd", "max_colors", "distance",
              "scheme", "rungs", "batch", "dims", "axes")


@pytest.mark.parametrize("pad_batch", [True, False])
@pytest.mark.parametrize("scheme", ["sparse", "allgather", "auto"])
@pytest.mark.parametrize("halo", [1, 2])
def test_signatures_match_reference(halo, scheme, pad_batch):
    rs, ts = _parts(halo, 4)
    cr, ct = _cfgs(scheme, halo)
    field = lambda sig: tuple(getattr(sig, f) for f in SIG_FIELDS)
    for r, t in zip(rs, ts):
        assert field(R.plan_signature(r, cr)) == field(T.plan_signature(t, ct))
        assert (R.plan_signature(r, cr).cfg.recolor.scheme
                == T.plan_signature(t, ct).cfg.recolor.scheme)
    for a, b in zip(R.bucket_graphs(rs), T.bucket_graphs(ts)):
        sa = R.bucket_signature(a, cr, pad_batch=pad_batch)
        sb = T.bucket_signature(b, ct, pad_batch=pad_batch)
        assert field(sa) == field(sb)
        assert sa.cfg.color.scheme == sb.cfg.color.scheme
        assert sb.describe().startswith("kind=many_sim")


def test_program_cache_counts_and_bucket_device_cache():
    pgs = [T.partition_graph(T.rmat.rmat_good(5, 8, seed=s), 2)
           for s in (1, 2, 3)]
    cfg = _cfgs("sparse", 1)[1]
    cfg = dataclasses.replace(cfg, n_iters=1)
    buckets = T.bucket_graphs(pgs)
    T.program_cache_clear()
    sigs = {T.bucket_signature(b, cfg, pad_batch=False) for b in buckets}
    assert not any(T.program_cache_contains(s) for s in sigs)
    T.color_many(pgs, cfg, buckets=buckets, device="cpu")
    st = T.program_cache_stats()
    assert (st["misses"], st["traces"], st["hits"]) == (len(sigs),) * 2 + (0,)
    assert all(T.program_cache_contains(s) for s in sigs)
    arrays = [b.__dict__["_device_arrays"] for b in buckets]
    T.color_many(pgs, cfg, buckets=buckets, device="cpu")
    st = T.program_cache_stats()
    assert (st["misses"], st["hits"], st["size"]) == (len(sigs),) * 3
    # the same device tensors again: nothing copied for a warm bucket
    for b, before in zip(buckets, arrays):
        assert b.__dict__["_device_arrays"] is before
        assert len(before) == 1
    T.program_cache_clear()
    assert T.program_cache_stats() == dict(hits=0, misses=0, traces=0,
                                           size=0)


# -- the numpy satellites ------------------------------------------------------

def _assert_graph_equal(a, b):
    assert a.n == b.n
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    assert a.indices.dtype == b.indices.dtype


@pytest.mark.parametrize("args", [(300, 6, 0), (1000, 12, 4)])
def test_random_regular_ish_matches_reference(args):
    _assert_graph_equal(R.rmat.random_regular_ish(*args),
                        T.rmat.random_regular_ish(*args))


@pytest.mark.parametrize("args", [(2000, 16.0, 1, 2), (1500, 20.0, 2, 3)])
def test_geometric_matches_reference(args):
    _assert_graph_equal(R.rmat.geometric(*args), T.rmat.geometric(*args))


@pytest.mark.parametrize("name", sorted(R.rmat.SUITE_REAL)
                         + sorted(R.rmat.SUITE_RMAT))
def test_suites_match_reference(name):
    assert sorted(T.rmat.SUITE_REAL) == sorted(R.rmat.SUITE_REAL)
    assert sorted(T.rmat.SUITE_RMAT) == sorted(R.rmat.SUITE_RMAT)
    suite_r = {**R.rmat.SUITE_REAL, **R.rmat.SUITE_RMAT}
    suite_t = {**T.rmat.SUITE_REAL, **T.rmat.SUITE_RMAT}
    _assert_graph_equal(suite_r[name](), suite_t[name]())


def _greedy(g):
    """Sequential First Fit in id order (numpy): a valid coloring."""
    colors = np.zeros(g.n, np.int32)
    for v in range(g.n):
        taken = set(colors[g.indices[g.indptr[v]:g.indptr[v + 1]]].tolist())
        c = 1
        while c in taken:
            c += 1
        colors[v] = c
    return colors


def test_assert_valid_matches_reference():
    g = T.rmat.rmat_good(7, 8, seed=3)
    colors = _greedy(g)
    got, want = T.assert_valid(g, colors), R.assert_valid(g, colors)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))
    bad = colors.copy()
    bad[g.indices[g.indptr[0]]] = bad[0]
    msgs = []
    for fn in (R.assert_valid, T.assert_valid):
        with pytest.raises(AssertionError) as e:
            fn(g, bad, "seed coloring")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("P", [2, 4])
def test_message_stats_matches_reference(P):
    g = T.rmat.rmat_good(8, 8, seed=1)
    colors = _greedy(g)
    K = int(colors.max())
    rank = np.zeros(K + 1, np.int64)
    rank[1:] = np.random.default_rng(P).permutation(K) + 1
    want = R.message_stats(R.partition_graph(g, P), colors, rank)
    got = T.message_stats(T.partition_graph(g, P), colors, rank)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.message_reduction == want.message_reduction
    assert got.collective_reduction == want.collective_reduction


@pytest.mark.parametrize("shape", [(10, 4, 3, 0), (2**31, 4, 3, 0),
                                   (1000, 2**20, 2**12, 0),
                                   (1000, 2**20, 2, 2**12)])
def test_id_policy_and_int32_guard_match_reference(shape):
    pr, pt = R.id_policy(*shape), T.id_policy(*shape)
    assert (pr.promoted, pr.id_itemsize, pr.ell) == (
        pt.promoted, pt.id_itemsize, pt.ell)
    assert np.dtype(pr.id_dtype) == np.dtype(pt.id_dtype)
    assert np.dtype(pr.ell_dtype) == np.dtype(pt.ell_dtype)
    raised = []
    for fn in (R.check_int32_limits, T.check_int32_limits):
        try:
            fn(*shape)
            raised.append(None)
        except ValueError as e:
            raised.append(str(e))
    assert raised[0] == raised[1]
    assert T.IdPolicy is type(pt)
    assert T.stats_to_host({"a": 1}) == {"a": 1}
