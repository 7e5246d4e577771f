"""Graph generators: numpy copies of ``repro.core.rmat``'s RMAT family and
its 2D/3D stencil grids.

The paper (§4.1) evaluates three RMAT classes: RMAT-ER (0.25,0.25,0.25,0.25),
RMAT-Good (0.45,0.15,0.15,0.25) and RMAT-Bad (0.55,0.15,0.15,0.15); the
stencil grids are the distance-2 workloads.  Every generator returns a
symmetric, dedup'ed, self-loop-free CSR graph, equal array for array to
the reference's for the same arguments.
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


def grid2d(rows: int, cols: int, stencil: int = 9) -> Graph:
    """2D grid with a 5- or 9-point stencil (an FE-mesh stand-in)."""
    if stencil not in (5, 9):
        raise ValueError(f"stencil must be 5 or 9, got {stencil}")
    n = rows * cols
    ii, jj = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    # promote at the packing site: id * size + id wraps at 2**31 on int32
    vid = (ii.astype(np.int64) * cols + jj).ravel()
    offsets = [(-1, 0), (1, 0), (0, -1), (0, 1)]
    if stencil == 9:
        offsets += [(-1, -1), (-1, 1), (1, -1), (1, 1)]
    srcs, dsts = [], []
    for di, dj in offsets:
        ni, nj = ii + di, jj + dj
        ok = (ni >= 0) & (ni < rows) & (nj >= 0) & (nj < cols)
        srcs.append(vid[ok.ravel()])
        dsts.append((ni.astype(np.int64) * cols + nj).ravel()[ok.ravel()])
    return _edges_to_graph(n, np.concatenate(srcs).astype(np.int32),
                           np.concatenate(dsts).astype(np.int32))


def grid3d(nx: int, ny: int, nz: int) -> Graph:
    """3D grid with the 27-point stencil (HPCG's operator pattern; the
    FE/FD Jacobian that distance-2 coloring compresses)."""
    n = nx * ny * nz
    ii, jj, kk = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                             indexing="ij")
    vid = (ii.astype(np.int64) * ny * nz + jj * nz + kk).ravel()
    srcs, dsts = [], []
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            for dk in (-1, 0, 1):
                if di == dj == dk == 0:
                    continue
                ni, nj, nk = ii + di, jj + dj, kk + dk
                ok = ((ni >= 0) & (ni < nx) & (nj >= 0) & (nj < ny)
                      & (nk >= 0) & (nk < nz))
                srcs.append(vid[ok.ravel()])
                dsts.append((ni.astype(np.int64) * ny * nz + nj * nz
                             + nk).ravel()[ok.ravel()])
    return _edges_to_graph(n, np.concatenate(srcs).astype(np.int32),
                           np.concatenate(dsts).astype(np.int32))
