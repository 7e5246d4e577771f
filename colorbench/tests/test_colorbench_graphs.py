"""The benchmark's graph generators: symmetric, without self-loops or
repeated edges, the same edges for the same seed."""
from __future__ import annotations

import pytest
import torch

from colorbench import graphs, reference

CPU = torch.device("cpu")


def edges(indptr, indices):
    return reference.rows_of(indptr), indices


def check_csr(indptr, indices, n):
    assert indptr.shape == (n + 1,) and int(indptr[0]) == 0
    assert int(indptr[-1]) == indices.numel()
    src, dst = edges(indptr, indices)
    assert not bool((src == dst).any()), "self-loop"
    key = src * n + dst
    assert bool((key[1:] > key[:-1]).all()), "rows unsorted or repeated"
    back = torch.sort(dst * n + src).values
    assert torch.equal(back, key), "not symmetric"


@pytest.mark.parametrize("seed", [0, 3, 2**31 + 7])
def test_rmat_is_a_simple_symmetric_graph(seed):
    indptr, indices = graphs.rmat(10, 8, (0.45, 0.15, 0.15, 0.25), seed, CPU)
    check_csr(indptr, indices, 1 << 10)
    # the skew of RMAT-Good: vertex 0 gathers far more than the mean degree
    deg = indptr.diff()
    assert int(deg[0]) > 4 * float(deg.float().mean())


def test_rmat_same_seed_same_edges():
    a = graphs.rmat(9, 8, (0.45, 0.15, 0.15, 0.25), 2**31 + 3, CPU)
    b = graphs.rmat(9, 8, (0.45, 0.15, 0.15, 0.25), 2**31 + 3, CPU)
    c = graphs.rmat(9, 8, (0.45, 0.15, 0.15, 0.25), 2**31 + 4, CPU)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert a[1].shape != c[1].shape or not torch.equal(a[1], c[1])


@pytest.mark.parametrize("dims", [(4, 5, 6), (8, 8, 8)])
def test_grid3d_is_the_27_point_stencil(dims):
    nx, ny, nz = dims
    n = nx * ny * nz
    indptr, indices = graphs.grid3d(nx, ny, nz, CPU)
    check_csr(indptr, indices, n)
    deg = indptr.diff()
    assert int(deg.max()) == 26
    # every pair of points that differ by at most 1 in each coordinate
    pairs = (3 * nx - 2) * (3 * ny - 2) * (3 * nz - 2) - n
    assert indices.numel() == pairs


def test_grid3d_at_the_cell_size_matches_its_record():
    indptr, indices = graphs.grid3d(64, 64, 64, CPU)
    assert indices.numel() == 6_596_856


def test_make_graph_names_its_generator():
    with pytest.raises(ValueError, match="unknown generator"):
        graphs.make_graph({"generator": "nope"}, 0, CPU)
