"""The benchmark's graph generators, independent of the program.

Every generator returns a symmetric CSR without self-loops or repeated
edges, as two device tensors: ``indptr`` ``(n + 1,)`` int64 and
``indices`` ``(nnz,)`` int64, rows sorted.  The benchmark hands the host
copy of that CSR to the program and keeps it for the reference.

- ``rmat``: the R-MAT recursion of Chakrabarti et al. as Graph500 draws it:
  ``n * edge_factor`` directed edges, each choosing one of the four
  quadrants with probabilities (a, b, c, d) at every one of ``scale``
  levels, drawn on the device from a ``torch.Generator`` seeded with the
  run's seed (one draw of all edges per level), then symmetrised,
  deduplicated and stripped of self-loops.
- ``grid3d``: the 27-point stencil of an ``nx * ny * nz`` grid (HPCG's
  operator pattern): every vertex joined to the up to 26 others of its
  3 x 3 x 3 neighbourhood.  It takes no seed.
"""
from __future__ import annotations

import torch

SEED_MASK = 2**64 - 1


def csr_from_edges(n: int, src: torch.Tensor, dst: torch.Tensor):
    """Symmetrise, deduplicate and strip self-loops from directed edges
    ``src -> dst`` (int64 tensors); returns ``(indptr, indices)`` on their
    device."""
    keep = src != dst
    src, dst = src[keep], dst[keep]
    keys = torch.unique(torch.cat([src * n + dst, dst * n + src]))  # sorted
    rows = torch.div(keys, n, rounding_mode="floor")
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=keys.device)
    indptr[1:] = torch.cumsum(torch.bincount(rows, minlength=n), 0)
    return indptr, keys - rows * n


def rmat(scale: int, edge_factor: int, probs, seed: int, device):
    """An R-MAT graph of ``2**scale`` vertices (see the module docstring)."""
    a, b, c, _ = (float(p) for p in probs)
    n = 1 << scale
    m = n * edge_factor
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & SEED_MASK)
    src = torch.zeros(m, dtype=torch.int64, device=device)
    dst = torch.zeros(m, dtype=torch.int64, device=device)
    for _ in range(scale):
        r = torch.rand(m, generator=gen, device=device)
        # quadrants: a top left, b top right, c bottom left, d bottom right
        src = src * 2 + (r >= a + b).long()
        dst = dst * 2 + (((r >= a) & (r < a + b)) | (r >= a + b + c)).long()
    return csr_from_edges(n, src, dst)


def grid3d(nx: int, ny: int, nz: int, device):
    """The 27-point stencil graph of an ``nx * ny * nz`` grid."""
    n = nx * ny * nz
    v = torch.arange(n, dtype=torch.int64, device=device)
    i, j, k = v // (ny * nz), (v // nz) % ny, v % nz
    src, dst = [], []
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            for dk in (-1, 0, 1):
                if di == dj == dk == 0:
                    continue
                ok = ((i + di >= 0) & (i + di < nx) & (j + dj >= 0)
                      & (j + dj < ny) & (k + dk >= 0) & (k + dk < nz))
                src.append(v[ok])
                dst.append(v[ok] + di * ny * nz + dj * nz + dk)
    return csr_from_edges(n, torch.cat(src), torch.cat(dst))


GENERATORS = {
    "rmat": lambda cfg, seed, device: rmat(
        cfg["scale"], cfg["edge_factor"], cfg["probs"], seed, device),
    "grid3d": lambda cfg, seed, device: grid3d(
        cfg["nx"], cfg["ny"], cfg["nz"], device)}


def make_graph(cfg: dict, seed: int, device):
    """The CSR of configuration ``cfg`` (its ``generator`` names one of
    ``GENERATORS``) for ``seed``, on ``device``."""
    try:
        gen = GENERATORS[cfg["generator"]]
    except KeyError:
        raise ValueError(f"unknown generator {cfg.get('generator')!r}; "
                         f"known: {sorted(GENERATORS)}") from None
    return gen(cfg, seed, device)
