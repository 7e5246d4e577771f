"""Validation and statistics helpers (host-side, numpy).

A copy of ``repro.core.validate``: distance-1 and distance-2 checks, with
the partial (``marked``) vertex subset.
"""
from __future__ import annotations

import numpy as np
import torch

from .graph import Graph, PartitionedGraph


def colors_from_views(pg: PartitionedGraph, views) -> np.ndarray:
    """(P, n_slots) views (tensor on any device, or numpy) -> (n_global,)."""
    if isinstance(views, torch.Tensor):
        views = views.cpu().numpy()
    views = np.asarray(views)
    return pg.gather_global_colors(views[:, : pg.n_local_max])


def _d2_conflicting_pairs(g: Graph, colors: np.ndarray,
                          marked: np.ndarray) -> int:
    """Distinct marked vertex pairs with a common neighbour + equal color.

    Distance-2 properness == for every vertex w, the (marked, colored)
    neighbours of w carry pairwise-distinct colors; duplicates are found by
    sorting each CSR row's neighbour colors (one global lexsort).  The count
    dedups witness pairs, so it is exact for "zero conflicts" and a witness
    count (adjacent duplicates per row) otherwise.
    """
    src = np.repeat(np.arange(g.n), g.degrees)
    nbr = g.indices
    ok = marked[nbr] & (colors[nbr] > 0)
    w, c, v = src[ok], colors[nbr[ok]], nbr[ok]
    order = np.lexsort((v, c, w))
    w, c, v = w[order], c[order], v[order]
    dup = (w[1:] == w[:-1]) & (c[1:] == c[:-1])
    if not dup.any():
        return 0
    a = np.minimum(v[1:][dup], v[:-1][dup]).astype(np.int64)
    b = np.maximum(v[1:][dup], v[:-1][dup]).astype(np.int64)
    return int(np.unique(a * g.n + b).shape[0])


def check_coloring(g: Graph, colors: np.ndarray, *, distance: int = 1,
                   marked: np.ndarray | None = None) -> dict:
    """Validity + quality stats of a global coloring.

    ``colors`` — ``(g.n,)`` 1-based ints (0 = uncolored).  ``distance=2``
    additionally requires any two (marked) vertices with a common
    neighbour to differ in color.  ``marked`` — ``(g.n,)`` bool — restricts
    the checked vertex set (partial coloring): unmarked vertices may stay
    uncolored and never count as conflicts.  Returns a dict: ``valid``;
    ``n_conflicting_edges`` (undirected); ``n_uncolored``; ``n_colors`` —
    *distinct* colors in use, the paper's quality metric;
    ``max_color_id``; ``class_sizes`` — ``(max_color_id,)`` counts indexed
    by color id - 1; ``class_balance`` — std/mean of the non-empty class
    sizes; and at distance 2 ``n_d2_conflicting_pairs``.  Sentinel colors
    (``<= 0``) count as uncolored.
    """
    if distance not in (1, 2):
        raise ValueError(f"distance must be 1 or 2, got {distance}")
    colors = np.asarray(colors)
    if marked is None:
        marked = np.ones(g.n, dtype=bool)
    else:
        marked = np.asarray(marked, dtype=bool)
    src = np.repeat(np.arange(g.n), g.degrees)
    both = marked[src] & marked[g.indices]
    bad = both & (colors[src] > 0) & (colors[src] == colors[g.indices])
    n_uncolored = int((marked & (colors <= 0)).sum())
    cm = colors[marked]
    cm = cm[cm > 0]
    max_color_id = int(cm.max(initial=0))
    n_colors = int(np.unique(cm).size)
    counts = np.bincount(cm, minlength=max_color_id + 1)[1:]
    nonempty = counts[counts > 0]
    out = dict(
        valid=n_uncolored == 0 and not bad.any(),
        n_conflicting_edges=int(bad.sum()) // 2,
        n_uncolored=n_uncolored,
        n_colors=n_colors,
        max_color_id=max_color_id,
        class_sizes=counts,
        class_balance=float(nonempty.std() / max(nonempty.mean(), 1e-9))
        if n_colors else 0.0,
    )
    if distance == 2:
        n_d2 = _d2_conflicting_pairs(g, colors, marked)
        out["n_d2_conflicting_pairs"] = n_d2
        out["valid"] = out["valid"] and n_d2 == 0
    return out


def assert_valid(g: Graph, colors: np.ndarray, what: str = "coloring", *,
                 distance: int = 1, marked: np.ndarray | None = None):
    """``check_coloring``, raising ``AssertionError`` with the counts when
    the coloring is not valid; returns the stats."""
    st = check_coloring(g, colors, distance=distance, marked=marked)
    assert st["valid"], (
        f"invalid {what}: {st['n_conflicting_edges']} conflicting edges, "
        f"{st.get('n_d2_conflicting_pairs', 0)} d2 pairs, "
        f"{st['n_uncolored']} uncolored, min color {colors.min(initial=0)}")
    return st
