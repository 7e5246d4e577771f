"""R-MAT graph generators (numpy copy of ``repro.core.rmat``'s RMAT family).

The paper (§4.1) evaluates three RMAT classes: RMAT-ER (0.25,0.25,0.25,0.25),
RMAT-Good (0.45,0.15,0.15,0.25) and RMAT-Bad (0.55,0.15,0.15,0.15).  Every
generator returns a symmetric, dedup'ed, self-loop-free CSR graph, equal
array for array to the reference's for the same arguments.
"""
from __future__ import annotations

import numpy as np

from .graph import Graph, _unique_pairs, id_policy


def _edges_to_graph(n: int, src: np.ndarray, dst: np.ndarray) -> Graph:
    """Symmetrize + dedup an edge list into CSR (lexsort dedup: no packed
    ``u * n + v`` key to overflow)."""
    pol = id_policy(n, 1, 1)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    u, v = _unique_pairs(np.concatenate([src, dst]), np.concatenate([dst, src]))
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, u.astype(np.int64) + 1, 1)
    indptr = np.cumsum(indptr)
    return Graph(n=n, indptr=indptr.astype(np.int64),
                 indices=v.astype(pol.id_dtype))


def rmat(
    scale: int,
    edge_factor: int = 8,
    probs: tuple[float, float, float, float] = (0.25, 0.25, 0.25, 0.25),
    seed: int = 0,
) -> Graph:
    """R-MAT generator (Chakrabarti et al.), recursive quadrant sampling.

    ``scale``: log2 of the number of vertices. ``edge_factor``: directed
    edges generated per vertex before symmetrization/dedup.
    """
    n = 1 << scale
    m = n * edge_factor
    rng = np.random.default_rng(seed)
    a, b, c, d = probs
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    for _ in range(scale):
        r = rng.random(m)
        right = (r >= a + b) & (r < a + b + c) | (r >= a + b + c)
        down = ((r >= a) & (r < a + b)) | (r >= a + b + c)
        src = src * 2 + right.astype(np.int64)
        dst = dst * 2 + down.astype(np.int64)
    return _edges_to_graph(n, src, dst)


def rmat_er(scale: int, edge_factor: int = 8, seed: int = 0) -> Graph:
    return rmat(scale, edge_factor, (0.25, 0.25, 0.25, 0.25), seed)


def rmat_good(scale: int, edge_factor: int = 8, seed: int = 0) -> Graph:
    return rmat(scale, edge_factor, (0.45, 0.15, 0.15, 0.25), seed)


def rmat_bad(scale: int, edge_factor: int = 8, seed: int = 0) -> Graph:
    return rmat(scale, edge_factor, (0.55, 0.15, 0.15, 0.15), seed)
