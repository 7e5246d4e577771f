"""The port's distance-2 recoloring and color→recolor pipeline against the
reference's, bit for bit.

Same halo-2 partition, same seed coloring, same keys, at the reference's
``tests/test_d2.py`` sizes: views, stats (``wire_bytes`` and
``n_exchanges`` included) and per-iteration histories must be equal
(integer outputs, tolerance 0).  The reference runs live under
``jax_threefry_partitionable=True``, set explicitly.
"""
import dataclasses
from functools import lru_cache

import jax
import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro_torch.core.graph import arrays_from_numpy, view_from_numpy

GRAPHS = {
    "grid2d": lambda m: m.rmat.grid2d(12, 12, 9),
    "grid3d": lambda m: m.rmat.grid3d(6, 6, 6),
    "rmat_good": lambda m: m.rmat.rmat_good(8, 8, seed=1),
}
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
def _seed_view(gname, P):
    """The reference's Random-X D2 coloring: the recoloring seed."""
    pr, _, order, _ = _parts(gname, P)
    with jax.threefry_partitionable(True):
        view, _ = R.color_graph_sim(
            pr, order, R.ColorConfig(selection="random_x", **CFG))
    return np.asarray(view)


def _marked(g, pg):
    """The reference's ``TestPartialD2._marked``: even global ids."""
    marked_g = np.arange(g.n) % 2 == 0
    marked = np.zeros((pg.P, pg.n_local_max), bool)
    for p in range(pg.P):
        nl, lo = int(pg.n_local[p]), int(pg.offs[p])
        marked[p, :nl] = marked_g[lo:lo + nl]
    return marked_g, marked


def _pipeline_cfgs(scheme, sel="random_x", partial=False, n_iters=3):
    color = dict(selection=sel, scheme=scheme, partial=partial, **CFG)
    recolor = dict(max_colors=512, distance=2, scheme=scheme)
    return (R.PipelineConfig(color=R.ColorConfig(**color),
                             recolor=R.RecolorConfig(**recolor),
                             n_iters=n_iters),
            T.PipelineConfig(color=T.ColorConfig(**color),
                             recolor=T.RecolorConfig(**recolor),
                             n_iters=n_iters))


@pytest.mark.parametrize("scheme", ["sparse", "allgather"])
@pytest.mark.parametrize("piggyback", [True, False], ids=["piggy", "every"])
@pytest.mark.parametrize("perm", [R.RV, R.NI, R.ND])
def test_recolor_d2_matches_reference(perm, piggyback, scheme):
    """One D2 RC iteration on the reference's own partition and seed
    coloring, carried into the port by ``arrays_from_numpy``, and through
    the port's own partition by ``recolor_sim``."""
    pr, pt, _, g = _parts("rmat_good", 4)
    seed = _seed_view("rmat_good", 4)
    rcfg = dict(max_colors=512, distance=2, piggyback=piggyback,
                scheme=scheme)
    vr, sr = R.recolor_sim(pr, seed, perm, R.RecolorConfig(**rcfg),
                           key=jax.random.key(0))
    arrs = arrays_from_numpy(pr.arrays(sparse=scheme == "sparse"), "cpu")
    vt, st = T.recolor_shards(arrs, view_from_numpy(seed, "cpu"), perm,
                              T.RecolorConfig(**rcfg))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vr))
    assert st == sr
    vd, sd = T.recolor_sim(pt, view_from_numpy(seed, "cpu"), perm,
                           T.RecolorConfig(**rcfg), device="cpu")
    assert torch.equal(vd, vt) and sd == st
    chk = T.check_coloring(g, T.colors_from_views(pt, vt), distance=2)
    assert chk["valid"], chk
    assert st["n_colors_distinct"] <= st["n_colors_before"]


@pytest.mark.parametrize("scheme", ["sparse", "allgather"])
@pytest.mark.parametrize("gname,P", [("grid2d", 16), ("grid3d", 4),
                                     ("grid3d", 16), ("rmat_good", 2)])
def test_pipeline_d2_matches_reference(gname, P, scheme):
    pr, pt, order, g = _parts(gname, P)
    cfg_r, cfg_t = _pipeline_cfgs(scheme)
    vr, rr = R.pipeline_sim(pr, order, cfg_r)
    vt, rt = T.pipeline_sim(pt, order, cfg_t, device="cpu")
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vr))
    assert rt["color"] == rr["color"]
    assert rt["history"] == rr["history"]
    assert rt["n_iters_run"] == rr["n_iters_run"] == 3
    chk = T.check_coloring(g, T.colors_from_views(pt, vt), distance=2)
    assert chk["valid"], chk


@pytest.mark.parametrize("scheme", ["sparse", "allgather"])
@pytest.mark.parametrize("gname", ["grid2d", "rmat_good"])
def test_partial_pipeline_d2_matches_reference(gname, scheme):
    """Partial D2 through the whole pipeline: recoloring keeps the
    unmarked vertices at 0 (class 0 is skipped) and the subset valid."""
    pr, pt, order, g = _parts(gname, 4)
    marked_g, marked = _marked(g, pt)
    cfg_r, cfg_t = _pipeline_cfgs(scheme, partial=True)
    vr, rr = R.pipeline_sim(pr, order, cfg_r, marked=marked)
    vt, rt = T.pipeline_sim(pt, order, cfg_t, marked=marked, device="cpu")
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vr))
    assert rt["color"] == rr["color"] and rt["history"] == rr["history"]
    colors = T.colors_from_views(pt, vt)
    assert (colors[~marked_g] == 0).all()
    chk = T.check_coloring(g, colors, distance=2, marked=marked_g)
    assert chk["valid"], chk


def test_pipeline_d2_adaptive_stop_matches_reference():
    pr, pt, order, _ = _parts("grid3d", 4)
    cfg_r, cfg_t = _pipeline_cfgs("sparse", sel="first_fit", n_iters=6)
    cfg_r = dataclasses.replace(cfg_r, patience=1)
    cfg_t = dataclasses.replace(cfg_t, patience=1)
    vr, rr = R.pipeline_sim(pr, order, cfg_r)
    vt, rt = T.pipeline_sim(pt, order, cfg_t, device="cpu")
    assert rt["n_iters_run"] == rr["n_iters_run"] < 6
    assert rt["history"] == rr["history"]
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vr))


def test_recolor_d2_needs_the_two_hop_halo():
    _, pt, order, _ = _parts("grid2d", 2, halo=1)
    view = torch.zeros((2, pt.n_slots), dtype=torch.int32)
    with pytest.raises(ValueError, match="halo=2"):
        T.recolor_sim(pt, view, T.ND,
                      T.RecolorConfig(max_colors=512, distance=2),
                      device="cpu")
    _, cfg_t = _pipeline_cfgs("sparse")
    with pytest.raises(ValueError, match="halo=2"):
        T.pipeline_sim(pt, order, cfg_t, device="cpu")


@pytest.mark.parametrize("color_d,recolor_d", [(2, 1), (1, 2)])
def test_pipeline_stages_must_agree_on_distance(color_d, recolor_d):
    with pytest.raises(ValueError, match="agree on distance"):
        T.PipelineConfig(color=T.ColorConfig(distance=color_d),
                         recolor=T.RecolorConfig(distance=recolor_d))
