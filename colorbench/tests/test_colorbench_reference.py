"""The plain reference: it rebuilds the program's slot map from n and P,
catches planted conflicts at distance 1 and 2, recolors exactly as the
program does, and counts the bytes of a hand-counted graph."""
from __future__ import annotations

import contextlib
import json

import numpy as np
import pytest
import torch

from colorbench import graphs, program, reference, yardstick
from conftest import BENCH, TINY_CONFIGS
from repro_torch.core.graph import Graph, partition_graph

CPU = torch.device("cpu")


@pytest.mark.parametrize("n,P,halo", [(512, 4, 1), (1000, 8, 1),
                                      (512, 4, 2)])
def test_slot_map_is_the_partitions(n, P, halo):
    indptr, indices = graphs.rmat(9, 4, (0.45, 0.15, 0.15, 0.25), 1, CPU)
    if n != 512:      # a block partition that does not divide evenly
        indptr, indices = graphs.grid3d(10, 10, 10, CPU)
    g = Graph(n=n, indptr=indptr.numpy(), indices=indices.numpy()
              .astype(np.int32))
    pg = partition_graph(g, P, halo=halo)
    idx = reference.slot_index(n, P, pg.n_slots, CPU)
    flat_gvid = torch.from_numpy(pg.gvid.astype(np.int64)).reshape(-1)
    assert torch.equal(flat_gvid[idx], torch.arange(n))


def _valid(distance):
    """A sequential First Fit coloring at ``distance`` of a tiny graph."""
    cfg = TINY_CONFIGS["tiny-grid" if distance == 2 else "tiny-rmat"]
    indptr, indices = graphs.make_graph(cfg, 5, CPU)
    ip, ix = indptr.tolist(), indices.tolist()
    nbrs = [ix[ip[v]:ip[v + 1]] for v in range(len(ip) - 1)]
    colors = [0] * len(nbrs)
    for v, row in enumerate(nbrs):
        near = set(row)
        if distance == 2:
            near |= {w for u in row for w in nbrs[u]}
        used = {colors[u] for u in near if u != v}
        colors[v] = next(c for c in range(1, len(used) + 2) if c not in used)
    return torch.tensor(colors), indptr, indices


@pytest.mark.parametrize("distance", [1, 2])
def test_conflicts_catch_a_planted_conflict(distance):
    colors, indptr, indices = _valid(distance)
    assert reference.conflicts(colors, indptr, indices, distance) == 0
    src = reference.rows_of(indptr)
    if distance == 1:
        u, v = int(src[0]), int(indices[0])
    else:      # vertex 0 and a vertex two hops from it, not one
        row = set(indices[indptr[0]:indptr[1]].tolist())
        two = {w for x in row
               for w in indices[indptr[x]:indptr[x + 1]].tolist()}
        u, v = 0, min(two - row - {0})
    planted = colors.clone()
    planted[v] = planted[u]
    assert reference.conflicts(planted, indptr, indices, distance) > 0


def test_out_of_range():
    c = torch.tensor([1, 2, 0, 1022, 1023, -1])
    assert reference.out_of_range(c, 1024) == 3


@pytest.mark.parametrize("config", sorted(TINY_CONFIGS))
def test_recolor_is_the_programs(config):
    cfg = TINY_CONFIGS[config]
    traffic = json.loads((BENCH / "traffic" / "quality.json").read_text())
    traffic["n_iters"] = 3
    indptr, indices = graphs.make_graph(cfg, 9, CPU)
    prog = program.Program(cfg, traffic, indptr.numpy(), indices.numpy(),
                           CPU)
    idx = reference.slot_index(len(indptr) - 1, cfg["shards"], prog.n_slots,
                               CPU)
    seen = {}
    view, _ = prog.solve(program.key(9, 0),
                         lambda name: contextlib.nullcontext(),
                         lambda v: seen.setdefault("initial", v))
    initial = reference.global_colors(seen["initial"], idx)
    want = reference.recolor(initial, indptr, indices, 3, cfg["distance"],
                             1024)
    assert torch.equal(reference.global_colors(view, idx), want)
    got = reference.judge(initial, want, indptr, indices,
                          distance=cfg["distance"], n_iters=3,
                          max_colors=1024)
    assert all(v == 0 for v in got.values()), got


def test_pass_bytes_of_a_hand_counted_graph():
    # a triangle and an isolated vertex: n 4, six adjacency entries
    indptr = torch.tensor([0, 2, 4, 6, 6])
    indices = torch.tensor([1, 2, 0, 2, 0, 1])
    n, nnz = len(indptr) - 1, len(indices)
    # ids 6 x 4, offsets 5 x 4, colors read 4 x 4 and written 4 x 4
    assert yardstick.pass_bytes(n, nnz) == 24 + 20 + 16 + 16
    assert yardstick.roofline_pct(3.35e12, 1.0) == pytest.approx(100.0)
    assert yardstick.roofline_pct(1.0, 0.0) is None
