"""Vertex-visit orderings (paper §2.1, §2.2.1): numpy copy of
``repro.core.ordering``.

Each processor computes an ordering of *its own* vertices from the knowledge
it has (paper: "we let each processor compute an ordering of the graph based
on the knowledge it has"), so the distributed ordering differs from the
sequential one — which is exactly the effect the paper studies.

Orders are host-side preprocessing (numpy) and are returned as
``(P, n_local_max)`` arrays of local slot ids, padded with -1 (skipped).
"""
from __future__ import annotations

import numpy as np

from .graph import PartitionedGraph

NATURAL = "natural"
LARGEST_FIRST = "lf"
SMALLEST_LAST = "sl"
INTERNAL_FIRST = "internal_first"
BOUNDARY_FIRST = "boundary_first"

ALL_ORDERINGS = (NATURAL, LARGEST_FIRST, SMALLEST_LAST, INTERNAL_FIRST,
                 BOUNDARY_FIRST)


def _sl_local(pg: PartitionedGraph, p: int) -> np.ndarray:
    """Smallest-last over processor p's owned vertices (bucket queue, O(E))."""
    nl = int(pg.n_local[p])
    indptr = pg.indptr[p]
    indices = pg.indices[p]
    deg = pg.degree[p, :nl].astype(np.int64).copy()
    maxd = int(deg.max(initial=0))
    # bucket queue
    order = np.empty(nl, dtype=np.int32)
    removed = np.zeros(nl, dtype=bool)
    buckets: list[list[int]] = [[] for _ in range(maxd + 1)]
    for v in range(nl):
        buckets[deg[v]].append(v)
    cur = 0
    for k in range(nl - 1, -1, -1):
        # find the minimum-degree live vertex (lazy deletion of stale entries)
        while True:
            while cur <= maxd and not buckets[cur]:
                cur += 1
            v = buckets[cur].pop()
            if not removed[v] and deg[v] == cur:
                break
        removed[v] = True
        order[k] = v
        for e in range(indptr[v], indptr[v + 1]):
            u = indices[e]
            if u < nl and not removed[u]:
                deg[u] -= 1
                buckets[deg[u]].append(u)
                if deg[u] < cur:
                    cur = deg[u]
    return order


def compute_order(pg: PartitionedGraph, kind: str, *, seed: int = 0) -> np.ndarray:
    """(P, n_local_max) int32 visit order of local slots, padded with -1."""
    P, nmax = pg.P, pg.n_local_max
    out = np.full((P, nmax), -1, dtype=np.int32)
    for p in range(P):
        nl = int(pg.n_local[p])
        if nl == 0:
            continue
        if kind == NATURAL:
            o = np.arange(nl, dtype=np.int32)
        elif kind == LARGEST_FIRST:
            # stable sort, non-increasing degree (Welsh–Powell)
            o = np.argsort(-pg.degree[p, :nl], kind="stable").astype(np.int32)
        elif kind == SMALLEST_LAST:
            o = _sl_local(pg, p)
        elif kind == INTERNAL_FIRST:
            internal = np.nonzero(pg.is_internal[p, :nl])[0]
            boundary = np.nonzero(~pg.is_internal[p, :nl])[0]
            o = np.concatenate([internal, boundary]).astype(np.int32)
        elif kind == BOUNDARY_FIRST:
            internal = np.nonzero(pg.is_internal[p, :nl])[0]
            boundary = np.nonzero(~pg.is_internal[p, :nl])[0]
            o = np.concatenate([boundary, internal]).astype(np.int32)
        else:
            raise ValueError(f"unknown ordering {kind!r}")
        out[p, :nl] = o
    return out
