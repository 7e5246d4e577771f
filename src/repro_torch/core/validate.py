"""Validation and statistics helpers (host-side, numpy; distance 1).

A copy of ``repro.core.validate``'s distance-1 checks.
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


def check_coloring(g: Graph, colors: np.ndarray) -> dict:
    """Validity + quality stats of a global coloring.

    ``colors`` — ``(g.n,)`` 1-based ints (0 = uncolored).  Returns a dict:
    ``valid``; ``n_conflicting_edges`` (undirected); ``n_uncolored``;
    ``n_colors`` — *distinct* colors in use, the paper's quality metric;
    ``max_color_id``; ``class_sizes`` — ``(max_color_id,)`` counts indexed
    by color id - 1; ``class_balance`` — std/mean of the non-empty class
    sizes.  Sentinel colors (``<= 0``) count as uncolored.
    """
    colors = np.asarray(colors)
    src = np.repeat(np.arange(g.n), g.degrees)
    bad = (colors[src] > 0) & (colors[src] == colors[g.indices])
    n_uncolored = int((colors <= 0).sum())
    cm = colors[colors > 0]
    max_color_id = int(cm.max(initial=0))
    n_colors = int(np.unique(cm).size)
    counts = np.bincount(cm, minlength=max_color_id + 1)[1:]
    nonempty = counts[counts > 0]
    return dict(
        valid=n_uncolored == 0 and not bad.any(),
        n_conflicting_edges=int(bad.sum()) // 2,
        n_uncolored=n_uncolored,
        n_colors=n_colors,
        max_color_id=max_color_id,
        class_sizes=counts,
        class_balance=float(nonempty.std() / max(nonempty.mean(), 1e-9))
        if n_colors else 0.0,
    )
