"""The port's distance-2 and partial distance-2 speculative coloring
against the reference's, bit for bit.

Same graph, same halo-2 partition, same keys, at the reference's
``tests/test_d2.py`` sizes and settings: views and stats must be equal
(integer outputs, tolerance 0).  The reference runs live under
``jax_threefry_partitionable=True``, set explicitly.  Views are compared
over local slots and each shard's real ghosts where the two exchange
schemes meet (they treat ghost-slot padding differently).
"""
from functools import lru_cache

import jax
import numpy as np
import pytest

import repro.core as R
import repro_torch.core as T
from test_torch_threads import one_torch_thread  # noqa: F401

GRAPHS = {
    "grid2d": lambda m: m.rmat.grid2d(12, 12, 9),
    "grid3d": lambda m: m.rmat.grid3d(6, 6, 6),
    "rmat_good": lambda m: m.rmat.rmat_good(8, 8, seed=1),
}
P_SWEEP = (2, 4, 16)
CFG = dict(max_colors=512, superstep=64, tile=16, max_rounds=256, seed=0,
           distance=2)


@pytest.fixture(autouse=True)
def _partitionable():
    with jax.threefry_partitionable(True):
        yield


@lru_cache(maxsize=None)
def _parts(gname, P, halo=2):
    """(reference partition, port partition, NATURAL order, port graph)."""
    g_ref, g = GRAPHS[gname](R), GRAPHS[gname](T)
    pr = R.partition_graph(g_ref, P, halo=halo)
    order = R.compute_order(pr, R.ordering.NATURAL)
    return pr, T.partition_graph(g, P, halo=halo), order, g


@lru_cache(maxsize=None)
def _ref_color(gname, P, sel, partial=False):
    pr, pt, order, g = _parts(gname, P)
    marked = _marked(g, pt)[1] if partial else None
    with jax.threefry_partitionable(True):
        view, stats = R.color_graph_sim(
            pr, order, R.ColorConfig(selection=sel, partial=partial, **CFG),
            marked=marked)
    return np.asarray(view), stats


def _marked(g, pg):
    """The reference's ``TestPartialD2._marked``: even global ids."""
    marked_g = np.arange(g.n) % 2 == 0
    marked = np.zeros((pg.P, pg.n_local_max), bool)
    for p in range(pg.P):
        nl, lo = int(pg.n_local[p]), int(pg.offs[p])
        marked[p, :nl] = marked_g[lo:lo + nl]
    return marked_g, marked


def _assert_views_equal(pg, va, vb):
    """Bitwise equality over local slots + each shard's real ghosts."""
    np.testing.assert_array_equal(va[:, :pg.n_local_max],
                                  vb[:, :pg.n_local_max])
    for p in range(pg.P):
        ng = int(pg.n_ghost[p])
        np.testing.assert_array_equal(
            va[p, pg.n_local_max:pg.n_local_max + ng],
            vb[p, pg.n_local_max:pg.n_local_max + ng])


@pytest.mark.parametrize("sel", ["first_fit", "random_x"])
@pytest.mark.parametrize("P", P_SWEEP)
@pytest.mark.parametrize("gname", list(GRAPHS))
def test_color_d2_matches_reference(gname, P, sel):
    """The sparse run equals the reference's bitwise, the all-gather run
    on local slots and real ghosts (the reference's own scheme equality);
    stats equal but for the wire bytes, and the coloring is D2-valid."""
    pr, pt, order, g = _parts(gname, P)
    vr, sr = _ref_color(gname, P, sel)
    runs = {}
    for scheme in ("sparse", "allgather"):
        runs[scheme] = T.color_graph_sim(
            pt, order, T.ColorConfig(selection=sel, scheme=scheme, **CFG),
            device="cpu")
    vt, st = runs["sparse"]
    np.testing.assert_array_equal(vt.numpy(), vr)
    assert st == sr
    va, sa = runs["allgather"]
    _assert_views_equal(pt, va.numpy(), vr)
    no_bytes = lambda d: {k: v for k, v in d.items() if k != "wire_bytes"}
    assert no_bytes(sa) == no_bytes(sr)
    chk = T.check_coloring(g, T.colors_from_views(pt, vt), distance=2)
    assert chk["valid"] and chk["n_d2_conflicting_pairs"] == 0, chk
    assert chk["n_colors"] == st["n_colors_distinct"]


def test_color_d2_allgather_matches_reference_run():
    """One all-gather case against the reference's own all-gather run,
    view for view (padding included) and stat for stat."""
    pr, pt, order, _ = _parts("grid3d", 4)
    cfg = dict(selection="random_x", scheme="allgather", **CFG)
    vr, sr = R.color_graph_sim(pr, order, R.ColorConfig(**cfg))
    vt, st = T.color_graph_sim(pt, order, T.ColorConfig(**cfg), device="cpu")
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vr))
    assert st == sr


@pytest.mark.parametrize("sel", ["first_fit", "random_x"])
@pytest.mark.parametrize("gname", ["grid2d", "rmat_good"])
def test_partial_d2_matches_reference(gname, sel):
    """Bipartite partial coloring of the even ids: unmarked vertices stay
    0, the marked subset is D2-valid, never more colors than full D2."""
    pr, pt, order, g = _parts(gname, 4)
    marked_g, marked = _marked(g, pt)
    vr, sr = _ref_color(gname, 4, sel, partial=True)
    vt, st = T.color_graph_sim(
        pt, order, T.ColorConfig(selection=sel, partial=True, **CFG),
        marked=marked, device="cpu")
    np.testing.assert_array_equal(vt.numpy(), vr)
    assert st == sr
    colors = T.colors_from_views(pt, vt)
    assert (colors[~marked_g] == 0).all() and (colors[marked_g] > 0).all()
    chk = T.check_coloring(g, colors, distance=2, marked=marked_g)
    assert chk["valid"], chk
    assert st["n_colors"] <= _ref_color(gname, 4, sel)[1]["n_colors"]


@pytest.mark.parametrize("sel", ["first_fit", "random_x"])
def test_d1_on_halo2_partition_matches_halo1(sel):
    """The wider halo changes the comm structure, never a D1 coloring."""
    cfg = dict(max_colors=512, superstep=64, seed=0, selection=sel)
    _, p1, o1, g = _parts("rmat_good", 4, halo=1)
    pr2, p2, o2, _ = _parts("rmat_good", 4)
    v1, _ = T.color_graph_sim(p1, o1, T.ColorConfig(**cfg), device="cpu")
    v2, s2 = T.color_graph_sim(p2, o2, T.ColorConfig(**cfg), device="cpu")
    np.testing.assert_array_equal(T.colors_from_views(p1, v1),
                                  T.colors_from_views(p2, v2))
    vr, sr = R.color_graph_sim(pr2, o2, R.ColorConfig(**cfg))
    np.testing.assert_array_equal(v2.numpy(), np.asarray(vr))
    assert s2 == sr


def test_distance2_needs_the_two_hop_halo():
    _, pt, order, _ = _parts("grid2d", 2, halo=1)
    with pytest.raises(ValueError, match="halo=2"):
        T.color_graph_sim(pt, order, T.ColorConfig(**CFG), device="cpu")


def test_partial_and_marked_go_together():
    _, pt, order, g = _parts("grid2d", 2)
    with pytest.raises(ValueError, match="needs a marked"):
        T.color_graph_sim(pt, order, T.ColorConfig(partial=True, **CFG),
                          device="cpu")
    with pytest.raises(ValueError, match="requires partial=True"):
        T.color_graph_sim(pt, order, T.ColorConfig(**CFG),
                          marked=_marked(g, pt)[1], device="cpu")


@pytest.mark.parametrize("make", [
    lambda: T.ColorConfig(distance=3), lambda: T.RecolorConfig(distance=0)],
    ids=["color", "recolor"])
def test_bad_distance_raises(make):
    with pytest.raises(ValueError, match="distance"):
        make()
