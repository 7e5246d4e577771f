"""The plain reference that decides ``correct``: plain PyTorch on the
global CSR, independent of the program under test.

It imports nothing of the program.  It reads the program's output views
only to judge them, and works out again from ``n`` and ``P`` the map from
the program's (shard, slot) to a global vertex: the block partition gives
shard ``p`` the vertices ``[p * n // P, (p + 1) * n // P)`` in slots
``0 …``.

The guarantees a coloring of the benchmark is held to:

- every vertex has a color in ``[1, max_colors - 2]`` (``max_colors - 1``
  is the selection's saturation sentinel, and 0 is "uncolored");
- no two vertices within the configuration's distance share a color;
- after K recoloring iterations each vertex has exactly the color that K
  iterations of the paper's synchronous recoloring (Culberson's iterated
  greedy) give from the initial coloring: one iteration visits the color
  classes in the ND order (non-decreasing class size, ties by color id)
  and gives each vertex of a class the smallest color that no vertex
  within the distance, already recolored in this iteration, holds.

Every function takes tensors on one device and runs there.
"""
from __future__ import annotations

import torch

INT64_MAX = 2**63 - 1


# ------------------------------------------------------------ the slot map --

def block_offsets(n: int, P: int) -> torch.Tensor:
    """``(P + 1,)`` first global vertex of each shard, and ``n``."""
    return torch.tensor([p * n // P for p in range(P + 1)], dtype=torch.int64)


def slot_index(n: int, P: int, n_slots: int, device) -> torch.Tensor:
    """``(n,)`` index of each global vertex's slot in a flattened ``(P,
    n_slots)`` view."""
    offs = block_offsets(n, P).to(device)
    v = torch.arange(n, dtype=torch.int64, device=device)
    p = torch.searchsorted(offs, v, right=True) - 1
    return p * n_slots + (v - offs[p])


def global_colors(view: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``(n,)`` int64 colors of the global vertices from a ``(P, n_slots)``
    view, with ``index`` from ``slot_index``."""
    return view.reshape(-1)[index].long()


# ----------------------------------------------------------------- the CSR --

def rows_of(indptr: torch.Tensor) -> torch.Tensor:
    """``(nnz,)`` source row of every CSR entry."""
    n = indptr.numel() - 1
    return torch.repeat_interleave(torch.arange(n, device=indptr.device),
                                   indptr.diff())


def gather_rows(indptr: torch.Tensor, indices: torch.Tensor,
                rows: torch.Tensor):
    """The CSR entries of ``rows``: ``(seg, nbr)``, where ``seg[e]`` is the
    position in ``rows`` of the row that entry ``e`` belongs to."""
    deg = indptr[rows + 1] - indptr[rows]
    seg = torch.repeat_interleave(torch.arange(rows.numel(),
                                               device=rows.device), deg)
    first = torch.cumsum(deg, 0) - deg
    pos = torch.arange(seg.numel(), device=rows.device) - first[seg]
    return seg, indices[indptr[rows][seg] + pos]


# ------------------------------------------------------------- the checks --

def out_of_range(colors: torch.Tensor, max_colors: int) -> int:
    """Vertices without a color in ``[1, max_colors - 2]``."""
    return int(((colors < 1) | (colors > max_colors - 2)).sum())


def conflicts(colors: torch.Tensor, indptr: torch.Tensor,
              indices: torch.Tensor, distance: int) -> int:
    """0 exactly where no two colored vertices within ``distance`` share a
    color.  Distance 1: the edges whose ends share a color.  Distance 2:
    over every closed neighbourhood (a vertex and its neighbours, which
    holds every pair at distance 2 through its middle vertex), the colors
    that appear more than once, counted with their repeats."""
    src = rows_of(indptr)
    if distance == 1:
        return int(((src < indices) & (colors[src] == colors[indices])
                    & (colors[src] > 0)).sum())
    n = colors.numel()
    owner = torch.cat([torch.arange(n, device=colors.device), src])
    color = torch.cat([colors, colors[indices]])
    keep = color > 0
    keys = owner[keep] * (int(color.max()) + 1) + color[keep]
    return int(keys.numel() - torch.unique(keys).numel())


# ------------------------------------------------------- the recoloring --

def nd_rank(colors: torch.Tensor, max_colors: int) -> torch.Tensor:
    """``(max_colors,)`` step (1-based) of each color class in the ND
    order; 0 for class 0 and absent classes."""
    c = colors.clamp(0, max_colors - 1)
    sizes = torch.bincount(c, minlength=max_colors)
    present = sizes > 0
    present[0] = False
    key = torch.where(present, sizes, INT64_MAX)
    order = torch.argsort(key, stable=True)
    rank = torch.empty(max_colors, dtype=torch.int64, device=colors.device)
    rank[order] = torch.arange(1, max_colors + 1, device=colors.device)
    return torch.where(present, rank, 0)


def first_fit(seg: torch.Tensor, taken: torch.Tensor, n_rows: int,
              max_colors: int) -> torch.Tensor:
    """``(n_rows,)`` smallest color ``>= 1`` of each row that no entry
    ``taken[e]`` of that row (``seg[e]``) holds, at most ``max_colors -
    1``."""
    width = int(taken.max()) + 2 if taken.numel() else 2
    used = torch.zeros((n_rows, width), dtype=torch.bool, device=seg.device)
    used[seg, taken] = True
    used[:, 0] = True
    return (~used).int().argmax(dim=1).clamp(max=max_colors - 1)


def recolor_once(colors: torch.Tensor, indptr: torch.Tensor,
                 indices: torch.Tensor, distance: int,
                 max_colors: int) -> torch.Tensor:
    """One ND recoloring iteration of a valid coloring."""
    step = nd_rank(colors, max_colors)[colors.clamp(0, max_colors - 1)]
    by_step = torch.argsort(step, stable=True)
    counts = torch.bincount(step).tolist()
    new = torch.zeros_like(colors)
    first = counts[0]
    for size in counts[1:]:
        cls = by_step[first:first + size]
        first += size
        seg, nbr = gather_rows(indptr, indices, cls)
        segs, taken = [seg], [new[nbr]]
        if distance == 2:
            seg2, nbr2 = gather_rows(indptr, indices, nbr)
            segs.append(seg[seg2])
            taken.append(new[nbr2])
        new[cls] = first_fit(torch.cat(segs), torch.cat(taken), cls.numel(),
                             max_colors)
    return new


def recolor(colors: torch.Tensor, indptr: torch.Tensor, indices: torch.Tensor,
            n_iters: int, distance: int, max_colors: int) -> torch.Tensor:
    """``n_iters`` ND recoloring iterations from ``colors``."""
    for _ in range(n_iters):
        colors = recolor_once(colors, indptr, indices, distance, max_colors)
    return colors


# ------------------------------------------------------------ the judge --

def judge(initial: torch.Tensor, final: torch.Tensor, indptr: torch.Tensor,
          indices: torch.Tensor, *, distance: int, n_iters: int,
          max_colors: int) -> dict:
    """Every number one solve is held to, by name: the initial coloring's
    and the final coloring's vertices out of range and conflicts, and the
    final vertices that differ from the reference's recoloring of the
    initial coloring.  Each has the limit 0."""
    want = recolor(initial, indptr, indices, n_iters, distance, max_colors)
    return {
        "color.out_of_range": out_of_range(initial, max_colors),
        "color.conflicts": conflicts(initial, indptr, indices, distance),
        "final.out_of_range": out_of_range(final, max_colors),
        "final.conflicts": conflicts(final, indptr, indices, distance),
        "final.differ": int((final != want).sum()),
    }


# ----------------------------------------------------------- the control --

def control_coloring(indptr: torch.Tensor, indices: torch.Tensor, P: int,
                     batch: int, max_colors: int) -> torch.Tensor:
    """The control: the reference in the program's place with one
    guarantee broken.  Each shard of the block partition colors its next
    ``batch`` vertices at once, all shards together, by First Fit against
    the colors already given, at distance 1, and no conflict is ever
    repaired: vertices colored together may share a color with a
    neighbour (or, at distance 2, with a vertex two hops away)."""
    n = indptr.numel() - 1
    dev = indptr.device
    offs = block_offsets(n, P).to(dev)
    colors = torch.zeros(n, dtype=torch.int64, device=dev)
    width = int((offs[1:] - offs[:-1]).max())
    for start in range(0, width, batch):
        rows = torch.cat([torch.arange(int(offs[p]) + start,
                                       min(int(offs[p]) + start + batch,
                                           int(offs[p + 1])), device=dev)
                          for p in range(P)])
        seg, nbr = gather_rows(indptr, indices, rows)
        colors[rows] = first_fit(seg, colors[nbr], rows.numel(), max_colors)
    return colors
