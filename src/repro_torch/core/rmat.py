"""Graph generators: numpy copies of ``repro.core.rmat``'s RMAT family, its
2D/3D stencil grids, its random and random geometric graphs, and the
evaluation suites ``SUITE_REAL`` / ``SUITE_RMAT``.

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


def random_regular_ish(n: int, deg: int, seed: int = 0) -> Graph:
    """Erdős–Rényi-flavoured graph with ~deg average degree."""
    rng = np.random.default_rng(seed)
    m = n * deg // 2
    src = rng.integers(0, n, m, dtype=np.int64).astype(np.int32)
    dst = rng.integers(0, n, m, dtype=np.int64).astype(np.int32)
    return _edges_to_graph(n, src, dst)


def geometric(n: int, avg_deg: float = 24.0, seed: int = 0,
              dims: int = 2) -> Graph:
    """Random geometric (unit-disk) graph — the closest synthetic analogue of
    the paper's FE meshes: local cliques, 30–50 greedy colors, orderings and
    class permutations matter. Built with cell-binned neighbour join."""
    rng = np.random.default_rng(seed)
    pts = rng.random((n, dims))
    # radius for expected degree: deg = n * V_d * r^d
    vd = np.pi if dims == 2 else 4.0 / 3.0 * np.pi
    r = (avg_deg / (n * vd)) ** (1.0 / dims)
    cell = r
    grid_n = max(int(1.0 / cell), 1)
    cid = np.minimum((pts / cell).astype(np.int64), grid_n - 1)
    # the cell key is packed in int64: it must not wrap int32
    key = cid[:, 0].astype(np.int64) * grid_n + cid[:, 1] if dims == 2 else (
        (cid[:, 0].astype(np.int64) * grid_n + cid[:, 1]) * grid_n
        + cid[:, 2])
    order = np.argsort(key)
    srcs, dsts = [], []
    offsets = ([(i, j) for i in (-1, 0, 1) for j in (-1, 0, 1)] if dims == 2
               else [(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1)
                     for k in (-1, 0, 1)])
    # bucket index: key -> member ids
    skey = key[order]
    starts = np.searchsorted(skey, np.arange(grid_n ** dims))
    ends = np.searchsorted(skey, np.arange(grid_n ** dims), side="right")

    def members(c):
        k = int(c[0]) * grid_n + int(c[1]) if dims == 2 else (
            (int(c[0]) * grid_n + int(c[1])) * grid_n + int(c[2]))
        return order[starts[k]:ends[k]]

    for cx in range(grid_n):
        for cy in range(grid_n):
            cells = [(cx, cy)] if dims == 2 else [
                (cx, cy, cz) for cz in range(grid_n)]
            for base in cells:
                a = members(base)
                if len(a) == 0:
                    continue
                neigh = []
                for off in offsets:
                    c2 = tuple(b + o for b, o in zip(base, off))
                    if all(0 <= v < grid_n for v in c2):
                        neigh.append(members(c2))
                b = np.concatenate(neigh)
                d2 = ((pts[a][:, None, :] - pts[b][None, :, :]) ** 2).sum(-1)
                ii, jj = np.nonzero(d2 <= r * r)
                srcs.append(a[ii])
                dsts.append(b[jj])
    return _edges_to_graph(n, np.concatenate(srcs).astype(np.int32),
                           np.concatenate(dsts).astype(np.int32))


# The paper's evaluation suite at a reduced scale. Keys mirror its Tables 1/2.
SUITE_REAL = {
    # name -> constructor (FE-style stand-ins for the UF/Parasol graphs)
    "grid2d_9pt": lambda: grid2d(256, 256, 9),
    "grid3d_27pt": lambda: grid3d(32, 32, 32),
    "geo2d": lambda: geometric(1 << 15, 28, seed=3),
    "geo3d": lambda: geometric(1 << 14, 36, seed=4, dims=3),
}
SUITE_RMAT = {
    "rmat_er": lambda: rmat_er(14, 8, seed=1),
    "rmat_good": lambda: rmat_good(14, 8, seed=1),
    "rmat_bad": lambda: rmat_bad(14, 8, seed=1),
}
