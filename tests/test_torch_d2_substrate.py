"""The port's distance-2 host substrate against the reference's.

The stencil generators, ``partition_graph(halo=2)`` (two-hop ghosts, the
widened boundary, ``nbr2``/``maxd2``, the comm plan and the visit orders)
and ``check_coloring(distance=2, marked=)`` are numpy copies in
``repro_torch``; every array and every stat must equal the reference's.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import comm as ref_comm
from repro.core import graph as ref_graph
from repro.core import ordering as ref_ordering
from repro.core import rmat as ref_rmat
from repro.core import validate as ref_validate
from repro_torch.core import comm, graph, ordering, rmat, validate

GRAPHS = {
    "grid2d": lambda m: m.grid2d(12, 12, 9),
    "grid3d": lambda m: m.grid3d(6, 6, 6),
    "rmat_good": lambda m: m.rmat_good(8, 8, seed=1),
}
P_SWEEP = (2, 4, 16)
_CACHE = {}


def _graphs(gname):
    """(reference graph, port graph) of ``gname``, built once."""
    if gname not in _CACHE:
        _CACHE[gname] = (GRAPHS[gname](ref_rmat), GRAPHS[gname](rmat))
    return _CACHE[gname]


def _assert_same(a, b, what):
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert a == b, what


@pytest.mark.parametrize("make", [
    lambda m: m.grid2d(12, 12, 9), lambda m: m.grid2d(7, 11, 5),
    lambda m: m.grid3d(6, 6, 6), lambda m: m.grid3d(3, 5, 4)],
    ids=["grid2d_9", "grid2d_5", "grid3d", "grid3d_uneven"])
def test_stencil_grids_match_reference(make):
    a, b = make(ref_rmat), make(rmat)
    assert a.n == b.n
    _assert_same(a.indptr, b.indptr, "indptr")
    _assert_same(a.indices, b.indices, "indices")


@pytest.mark.parametrize("P", P_SWEEP)
@pytest.mark.parametrize("gname", list(GRAPHS))
def test_halo2_partition_and_plan_match_reference(gname, P):
    g_ref, g = _graphs(gname)
    a = ref_graph.partition_graph(g_ref, P, halo=2)
    b = graph.partition_graph(g, P, halo=2)
    assert b.halo == 2 and b.nbr2.shape == (P, b.n_local_max, b.maxd2)
    for f in dataclasses.fields(b):
        _assert_same(getattr(a, f.name), getattr(b, f.name), f.name)
    pa, pb = a.comm_plan, b.comm_plan
    for f in dataclasses.fields(pb):
        _assert_same(getattr(pa, f.name), getattr(pb, f.name), f.name)
    for sparse in (True, False):
        da, db = a.arrays(sparse=sparse), b.arrays(sparse=sparse)
        assert da.keys() == db.keys() and "nbr2" in db
        for k in da:
            _assert_same(da[k], db[k], k)
    for kind in ordering.ALL_ORDERINGS:
        _assert_same(ref_ordering.compute_order(a, kind),
                     ordering.compute_order(b, kind), kind)
    assert comm.resolve_scheme(comm.AUTO, b) == ref_comm.resolve_scheme(
        ref_comm.AUTO, a)


def test_halo2_widens_the_halo():
    """Two-hop ghosts and the two-hop fringe: at halo 2 every shard holds
    at least the halo-1 ghosts, the boundary only grows, and the strict
    two-hop rows never repeat a one-hop neighbour."""
    _, g = _graphs("grid3d")
    h1, h2 = graph.partition_graph(g, 4), graph.partition_graph(g, 4, halo=2)
    assert h1.nbr2 is None and h1.maxd2 == 0 and "nbr2" not in h1.arrays()
    assert (h2.n_ghost > h1.n_ghost).all()
    assert (h2.n_boundary >= h1.n_boundary).all()
    assert not (h2.is_internal & ~h1.is_internal).any()
    for p in range(4):
        for v in range(int(h2.n_local[p])):
            one = set(h2.nbr[p, v]) - {h2.sentinel}
            two = set(h2.nbr2[p, v]) - {h2.sentinel}
            assert two and not one & two and v not in two


def test_reference_halo2_partition_through_arrays_from_numpy():
    """``arrays_from_numpy`` carries a reference halo-2 partition's device
    dict across unchanged: it equals the port's own ``to_device``."""
    g_ref, g = _graphs("rmat_good")
    a = ref_graph.partition_graph(g_ref, 4, halo=2)
    b = graph.partition_graph(g, 4, halo=2)
    carried = graph.arrays_from_numpy(a.arrays(), "cpu")
    own = graph.to_device(b, "cpu")
    assert carried.keys() == own.keys() and "nbr2" in own
    for k in own:
        assert carried[k].dtype == own[k].dtype, k
        assert torch.equal(carried[k], own[k]), k


@pytest.mark.parametrize("args", [(10, 5, 3), (10, 5, 3, 9), (2**20, 2**16,
                                  40, 2**15 + 1), (2**31 + 5, 7, 3, 2)])
def test_id_policy_with_maxd2_matches_reference(args):
    a, b = ref_graph.id_policy(*args), graph.id_policy(*args)
    assert (a.n_global, a.ell) == (b.n_global, b.ell)
    assert np.dtype(a.id_dtype) == np.dtype(b.id_dtype)
    assert np.dtype(a.ell_dtype) == np.dtype(b.ell_dtype)


def test_partition_rejects_a_bad_halo():
    with pytest.raises(ValueError, match="halo"):
        graph.partition_graph(_graphs("grid2d")[1], 2, halo=3)


def _colorings(g, seed):
    """(name, colors, marked) cases: a greedy valid distance-2 coloring,
    the same broken in three ways, and the partial (even ids) forms."""
    gen = np.random.default_rng(seed)
    colors = np.zeros(g.n, np.int64)
    src = np.repeat(np.arange(g.n), g.degrees)
    adj = [g.indices[g.indptr[v]:g.indptr[v + 1]] for v in range(g.n)]
    for v in gen.permutation(g.n):
        two = np.concatenate([adj[v]] + [adj[w] for w in adj[v]])
        taken = set(colors[two].tolist())
        colors[v] = next(c for c in range(1, g.n + 2) if c not in taken)
    d1_bad = colors.copy()
    d1_bad[g.indices[0]] = d1_bad[src[0]]                # an edge conflict
    w = int(np.argmax(g.degrees))
    a, b = next((a, b) for a in adj[w] for b in adj[w]   # no edge conflict
                if a != b and colors[a] not in colors[adj[b]])
    d2_bad = colors.copy()
    d2_bad[b] = d2_bad[a]                                # a common neighbour
    uncolored = colors.copy()
    uncolored[gen.choice(g.n, 3, replace=False)] = [0, -1, 0]
    even = np.arange(g.n) % 2 == 0
    partial = np.where(even, colors, 0)
    return [("valid", colors, None), ("d1_conflict", d1_bad, None),
            ("d2_conflict", d2_bad, None), ("uncolored", uncolored, None),
            ("partial", partial, even),
            ("partial_d2_conflict", np.where(even, d2_bad, 0), even),
            ("partial_unmarked_ignored", np.where(even, colors, 7), even)]


@pytest.mark.parametrize("distance", [1, 2])
@pytest.mark.parametrize("gname", ["grid2d", "rmat_good"])
def test_check_coloring_matches_reference(gname, distance):
    g_ref, g = _graphs(gname)
    verdicts = {}
    for name, colors, marked in _colorings(g, seed=7):
        want = ref_validate.check_coloring(g_ref, colors, distance=distance,
                                           marked=marked)
        got = validate.check_coloring(g, colors, distance=distance,
                                      marked=marked)
        assert got.keys() == want.keys(), name
        for k in want:
            _assert_same(want[k], got[k], f"{name}: {k}")
        verdicts[name] = got["valid"]
    assert verdicts["valid"] and verdicts["partial"]
    assert not verdicts["d1_conflict"] and not verdicts["uncolored"]
    assert verdicts["d2_conflict"] == (distance == 1)
    assert verdicts["partial_unmarked_ignored"]


def test_check_coloring_rejects_a_bad_distance():
    _, g = _graphs("grid2d")
    with pytest.raises(ValueError, match="distance"):
        validate.check_coloring(g, np.ones(g.n, np.int32), distance=3)
