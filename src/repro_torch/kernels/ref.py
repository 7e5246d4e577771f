"""Plain PyTorch versions of the color kernels (distance 1 and 2).

They are the CPU path of ``kernels.ops`` and the oracle the CUDA kernels
are held against on the card.  Semantics (the reference's
``repro/kernels/ref.py`` and ``firstfit.py`` contract):

- colors are 1-based; color 0 and any neighbour entry ``<= 0`` or
  ``>= max_colors`` are ignored (color 0 always counts as taken);
- color ``max_colors - 1`` is never free: it is the saturation sentinel
  returned when no color is permissible;
- first fit: the smallest free color; staggered: the smallest free color
  ``>= offset``, wrapping to first fit when there is none; Random-X: the
  ``rand % n_free``-th smallest free color, ``n_free = max(1, min(X,
  free colors))`` (uint32 arithmetic);
- conflict: a row loses iff it is active and a neighbour holds the same
  nonzero color with a strictly higher priority;
- inactive rows return 0 / False.

Both work on a whole ``(V, MAXD)`` tile through a ``(V, max_colors)``
occupancy mask — not the kernels' bitset walk — so they check the
kernels' arithmetic rather than repeat it.  The distance-2 versions run
the same mask over the one-hop and the strict two-hop tile side by side.

``select_run`` and ``recolor_run`` are the plain versions of the run
kernels: the speculative tile loop and the recolor chunk loop over
``(P, …)`` tensors, one ELL gather, one tile selection and one scatter
per tile, in order.  ``detect_conflicts_frontier`` is the plain version
of the frontier conflict kernels: the repair's chunk loop, one ELL
gather, one tile test and one scatter per superstep chunk.
"""
from __future__ import annotations

import torch


def take_rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-shard gather ``out[p, ...] = t[p, idx[p, ...]]``.

    ``t`` is ``(P, N, …)``, ``idx`` ``(P, …)`` of any integer dtype; the
    flat index is computed in int64.
    """
    P, N = t.shape[:2]
    base = torch.arange(P, device=t.device, dtype=torch.int64) * N
    base = base.view((P,) + (1,) * (idx.dim() - 1))
    return t.reshape((P * N,) + t.shape[2:])[base + idx]


def _first(mask: torch.Tensor) -> torch.Tensor:
    """(V, C) bool -> (V,) index of the first True, C - 1 where none."""
    c = mask.shape[1]
    first = mask.to(torch.uint8).argmax(dim=1)
    return torch.where(mask.any(dim=1), first, c - 1)


def select_colors(nbr_colors, active, rand_u32, offset, *, max_colors: int,
                  x: int, staggered: bool) -> torch.Tensor:
    """(V, MAXD) int32 tile -> (V,) int32 colors (0 where inactive).

    ``rand_u32`` is the int32 bit pattern of uint32 draws; ``offset`` the
    per-row staggered start color.
    """
    mc = max_colors
    v = nbr_colors.shape[0]
    ok = (nbr_colors > 0) & (nbr_colors < mc)
    taken = torch.zeros((v, mc), dtype=torch.bool, device=nbr_colors.device)
    taken.scatter_(1, torch.where(ok, nbr_colors, 0).long(), True)
    free = ~taken
    free[:, 0] = False
    free[:, mc - 1] = False
    if staggered:
        cols = torch.arange(mc, device=nbr_colors.device)
        color = _first(free & (cols >= offset[:, None]))
        color = torch.where(color == mc - 1, _first(free), color)
    elif x == 0:
        color = _first(free)
    else:
        rank = free.cumsum(dim=1)
        n_free = rank[:, -1].clamp(max=x).clamp(min=1)
        idx = (rand_u32.long() & 0xFFFFFFFF) % n_free
        color = _first(free & (rank == idx[:, None] + 1))
    return torch.where(active != 0, color, 0).to(torch.int32)


def detect_conflicts(my_color, my_prio, nbr_colors, nbr_prio,
                     active) -> torch.Tensor:
    """(V,), (V,), (V, MAXD), (V, MAXD), (V,) -> (V,) bool 'must recolor'."""
    same = (nbr_colors == my_color[:, None]) & (my_color[:, None] > 0)
    lose = (same & (nbr_prio > my_prio[:, None])).any(dim=1)
    return lose & (active != 0)


def select_colors_d2(nbr_colors, nbr2_colors, active, rand_u32, offset, *,
                     max_colors: int, x: int, staggered: bool) -> torch.Tensor:
    """(V, MAXD) one-hop and (V, MAXD2) two-hop tiles -> (V,) int32 colors:
    one occupancy mask over both tiles."""
    return select_colors(torch.cat([nbr_colors, nbr2_colors], dim=1), active,
                         rand_u32, offset, max_colors=max_colors, x=x,
                         staggered=staggered)


def detect_conflicts_d2(my_color, my_prio, nbr_colors, nbr_prio, nbr2_colors,
                        nbr2_prio, active) -> torch.Tensor:
    """Distance 2: a row loses against any one-hop or two-hop neighbour."""
    return detect_conflicts(my_color, my_prio,
                            torch.cat([nbr_colors, nbr2_colors], dim=1),
                            torch.cat([nbr_prio, nbr2_prio], dim=1), active)


def _select_tiles(tiles, active, rand, offset, *, max_colors: int, x: int,
                  staggered: bool) -> torch.Tensor:
    """``select_colors`` over ``(P, rows, MAXD)`` tiles (one, or the
    one-hop and the two-hop tile), ``(P, rows)`` active rows and draws (or
    None) and a broadcastable offset (or None) -> ``(P, rows)`` int32."""
    shape = active.shape
    row = lambda a: torch.broadcast_to(
        torch.as_tensor(0 if a is None else a, device=active.device),
        shape).reshape(-1)
    flat = torch.cat([t.reshape(-1, t.shape[-1]) for t in tiles], dim=1)
    out = select_colors(flat, row(active), row(rand), row(offset),
                        max_colors=max_colors, x=x, staggered=staggered)
    return out.reshape(shape)


def select_run(view, order_pad, nbrs: tuple, rand, offset, *,
               first_step: int, n_steps: int, superstep: int, tile: int,
               max_colors: int, x: int, staggered: bool):
    """Speculative supersteps ``first_step … first_step + n_steps - 1``,
    each as ``ceil(superstep / tile)`` tiles of ``tile`` rows of the visit
    order ``order_pad`` ``(P, L)``, against ``view`` ``(P, n_slots)``,
    which is updated in place and returned.

    A tile starts at ``min(si * superstep + ti * tile, L - tile)``; a row
    is active iff its entry is ``>= 0`` and its view color is 0; the whole
    tile reads the view before any of its colors is written.  ``nbrs`` is
    ``(nbr,)`` or ``(nbr, nbr2)``.
    """
    n_slots = view.shape[1]
    last = order_pad.shape[1] - tile      # lax.dynamic_slice clamps here
    for si in range(first_step, first_step + n_steps):
        for ti in range(-(-superstep // tile)):
            s0 = min(si * superstep + ti * tile, last)
            chunk = order_pad[:, s0:s0 + tile]                 # (P, tile)
            v_safe = chunk.clamp(min=0)
            active = (chunk >= 0) & (take_rows(view, v_safe) == 0)
            tiles = [take_rows(view, take_rows(n, v_safe)) for n in nbrs]
            colors = _select_tiles(
                tiles, active,
                None if rand is None else take_rows(rand, v_safe), offset,
                max_colors=max_colors, x=x, staggered=staggered)
            colors = colors.clamp(max=max_colors - 1)
            idx = torch.where(active, v_safe, n_slots - 1)   # park writes on
            val = torch.where(active, colors, 0)            # the sentinel
            view.scatter_(1, idx.long(), val.to(view.dtype))
    return view


def recolor_run(view, nbrs: tuple, sorted_pad, start, sizes, class_chunks,
                *, first_class: int, last_class: int, chunk: int,
                max_colors: int):
    """First Fit of recolor classes ``first_class … last_class`` in
    order, class t as ``class_chunks[t]`` chunks of ``chunk`` rows of the
    step-sorted rows ``sorted_pad`` ``(P, n_local_max + chunk)``, against
    ``view``, which is updated in place and returned.

    Chunk j of class t starts at ``min(start[p, t] + j * chunk,
    n_local_max)``; its row i is active iff ``j * chunk + i < sizes[p,
    t]``; the whole chunk reads the view before any of its colors is
    written.  ``nbrs`` as in ``select_run``.
    """
    n_slots = view.shape[1]
    n_local_max = nbrs[0].shape[1]
    lane = torch.arange(chunk, device=view.device)
    counts = class_chunks[first_class:last_class + 1].tolist()
    for t, n_chunks in enumerate(counts, start=first_class):
        for j in range(n_chunks):
            pos = (start[:, t] + j * chunk).clamp(max=n_local_max)
            active = lane < (sizes[:, t] - j * chunk)[:, None]
            rows = sorted_pad.gather(1, pos[:, None] + lane)
            rows = torch.where(active, rows, 0)
            tiles = [take_rows(view, take_rows(n, rows)) for n in nbrs]
            colors = _select_tiles(tiles, active, None, None,
                                   max_colors=max_colors, x=0,
                                   staggered=False)
            idx = torch.where(active, rows, n_slots - 1)    # park writes on
            val = torch.where(active, colors, 0)           # the sentinel
            view.scatter_(1, idx.long(), val.to(view.dtype))
    return view


def detect_conflicts_frontier(view, prio, is_internal, order_pad,
                              nbrs: tuple, n_need, *, n_steps: int,
                              superstep: int):
    """The repair of one speculative round over the first ``n_steps *
    superstep`` positions of the visit order ``order_pad`` ``(P, L)``,
    chunk by chunk; returns ``(new_view, n_conflicts,
    any_boundary_conflict)``, the last two as int64 and bool scalars.

    Position i of shard p is active iff its entry is ``>= 0`` and ``i <
    n_need[p]``; every chunk reads the same pre-detection ``view`` and
    writes its uncolorings into a copy.  ``nbrs`` is ``(nbr,)`` or
    ``(nbr, nbr2)``: a distance-2 row is tested against both tiles.
    """
    n_slots = view.shape[1]
    new_view = view.clone()
    n_conf = torch.zeros((), dtype=torch.int64, device=view.device)
    bnd = torch.zeros((), dtype=torch.bool, device=view.device)
    offs = torch.arange(superstep, device=view.device)
    test = detect_conflicts if len(nbrs) == 1 else detect_conflicts_d2
    flat = lambda t: t.reshape(-1, t.shape[-1])
    for si in range(n_steps):
        rows = order_pad[:, si * superstep:(si + 1) * superstep]
        active = (rows >= 0) & (si * superstep + offs < n_need[:, None])
        r_safe = rows.clamp(min=0)
        tiles = []
        for nbr in nbrs:
            nbr_rows = take_rows(nbr, r_safe)
            tiles += [flat(take_rows(view, nbr_rows)),
                      flat(take_rows(prio, nbr_rows))]
        conf = test(take_rows(view, r_safe).reshape(-1),
                    take_rows(prio, r_safe).reshape(-1), *tiles,
                    active.reshape(-1)).reshape(rows.shape)
        idx = torch.where(conf, r_safe, n_slots - 1)   # sentinel stays 0
        new_view.scatter_(1, idx.long(), 0)
        n_conf = n_conf + conf.sum()
        bnd = bnd | (conf & ~take_rows(is_internal, r_safe)).any()
    return new_view, n_conf, bnd
