"""Shared inputs of the port's distance-2 parity tests
(``tests/test_torch_d2_recolor.py``, ``tests/test_torch_d2_pipeline.py``):
the graphs at the reference's ``tests/test_d2.py`` sizes, their halo-2
partitions in both packages, the reference's seed coloring and the
configs."""
from functools import lru_cache

import jax
import numpy as np

import repro.core as R
import repro_torch.core as T

GRAPHS = {
    "grid2d": lambda m: m.rmat.grid2d(12, 12, 9),
    "grid3d": lambda m: m.rmat.grid3d(6, 6, 6),
    "rmat_good": lambda m: m.rmat.rmat_good(8, 8, seed=1),
}
CFG = dict(max_colors=512, superstep=64, tile=16, max_rounds=256, seed=0,
           distance=2)


@lru_cache(maxsize=None)
def parts(gname, P, halo=2):
    """(reference partition, port partition, NATURAL order, port graph)."""
    g_ref, g = GRAPHS[gname](R), GRAPHS[gname](T)
    pr = R.partition_graph(g_ref, P, halo=halo)
    order = R.compute_order(pr, R.ordering.NATURAL)
    return pr, T.partition_graph(g, P, halo=halo), order, g


@lru_cache(maxsize=None)
def seed_view(gname, P):
    """The reference's Random-X D2 coloring: the recoloring seed."""
    pr, _, order, _ = parts(gname, P)
    with jax.threefry_partitionable(True):
        view, _ = R.color_graph_sim(
            pr, order, R.ColorConfig(selection="random_x", **CFG))
    return np.asarray(view)


def marked_blocks(g, pg):
    """The reference's ``TestPartialD2._marked``: even global ids."""
    marked_g = np.arange(g.n) % 2 == 0
    marked = np.zeros((pg.P, pg.n_local_max), bool)
    for p in range(pg.P):
        nl, lo = int(pg.n_local[p]), int(pg.offs[p])
        marked[p, :nl] = marked_g[lo:lo + nl]
    return marked_g, marked


def pipeline_cfgs(scheme, sel="random_x", partial=False, n_iters=3):
    color = dict(selection=sel, scheme=scheme, partial=partial, **CFG)
    recolor = dict(max_colors=512, distance=2, scheme=scheme)
    return (R.PipelineConfig(color=R.ColorConfig(**color),
                             recolor=R.RecolorConfig(**recolor),
                             n_iters=n_iters),
            T.PipelineConfig(color=T.ColorConfig(**color),
                             recolor=T.RecolorConfig(**recolor),
                             n_iters=n_iters))
