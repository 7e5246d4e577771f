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
occupancy mask (``taken_mask`` and the row-wise strategies
``find_first_zero``, ``staggered``, ``random_x``, ``least_used``) — not
the kernels' bitset walk — so they check the kernels' arithmetic rather
than repeat it.  The distance-2 versions run
the same mask over the one-hop and the strict two-hop tile side by side.

``select_run`` and ``recolor_run`` are the plain versions of the run
kernels: the speculative tile loop and the recolor chunk loop over
``(P, …)`` tensors, one ELL gather, one tile selection and one scatter
per tile, in order.  ``detect_conflicts_frontier`` is the plain version
of the frontier conflict kernels: the repair's chunk loop, one ELL
gather, one tile test and one scatter per superstep chunk.
``greedy_run`` is the plain version of the sequential kernels: one
vertex per shard at a time through the same row-wise strategies, with
Least-Used beside them.  ``exchange_push`` is the plain version of the
push exchange: the recolored rows' fan-outs expanded and written with one
scatter.
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


def taken_mask(nbr_colors: torch.Tensor, max_colors: int) -> torch.Tensor:
    """``(rows, D)`` neighbour colors -> ``(rows, max_colors)`` bool mask of
    taken colors: colors ``<= 0`` or ``>= max_colors`` are ignored, color 0
    always counts as taken."""
    ok = (nbr_colors > 0) & (nbr_colors < max_colors)
    taken = torch.zeros((nbr_colors.shape[0], max_colors), dtype=torch.bool,
                        device=nbr_colors.device)
    taken.scatter_(1, torch.where(ok, nbr_colors, 0).long(), True)
    taken[:, 0] = True
    return taken


def _free(taken: torch.Tensor) -> torch.Tensor:
    free = ~taken
    free[:, -1] = False        # the saturation sentinel is never free
    return free


def _first(mask: torch.Tensor) -> torch.Tensor:
    """(V, C) bool -> (V,) index of the first True, C - 1 where none."""
    c = mask.shape[1]
    first = mask.to(torch.uint8).argmax(dim=1)
    return torch.where(mask.any(dim=1), first, c - 1)


def find_first_zero(taken: torch.Tensor) -> torch.Tensor:
    """First Fit: each row's smallest free color below the sentinel."""
    return _first(_free(taken))


def staggered(taken: torch.Tensor, offset: torch.Tensor) -> torch.Tensor:
    """Staggered First Fit: each row's smallest free color ``>= offset``
    ``(rows,)``, wrapping to First Fit when there is none."""
    free = _free(taken)
    cols = torch.arange(taken.shape[1], device=taken.device)
    color = _first(free & (cols >= offset[:, None]))
    return torch.where(color == taken.shape[1] - 1, _first(free), color)


def random_x(taken: torch.Tensor, x: int, rand: torch.Tensor) -> torch.Tensor:
    """Random-X: the ``rand % n_free``-th smallest free color, ``n_free =
    max(1, min(x, free colors))`` in uint32 arithmetic; ``rand`` ``(rows,)``
    holds uint32 draws (int32 bit patterns or int64 words)."""
    free = _free(taken)
    rank = free.cumsum(dim=1)
    n_free = rank[:, -1].clamp(max=x).clamp(min=1)
    idx = (rand.long() & 0xFFFFFFFF) % n_free
    return _first(free & (rank == idx[:, None] + 1))


def least_used(taken: torch.Tensor, usage: torch.Tensor) -> torch.Tensor:
    """Least-Used: each row's free color with the smallest positive
    ``usage`` ``(rows, max_colors)``, ties to the smaller color; First Fit
    where no open (``usage > 0``) color is free."""
    mc = taken.shape[1]
    ok = _free(taken) & (usage > 0)
    # usage * mc + color orders by usage, then by color
    score = torch.where(ok, usage.long() * mc
                        + torch.arange(mc, device=taken.device),
                        torch.iinfo(torch.int64).max)
    return torch.where(ok.any(dim=1), score.argmin(dim=1),
                       find_first_zero(taken))


def _pick(taken, *, x: int, stagger: bool, offset, rand, usage=None):
    """The row's color from its taken mask: Least-Used when ``usage`` is
    given, else Staggered, Random-X (``x > 0``) or First Fit."""
    if usage is not None:
        return least_used(taken, usage)
    if stagger:
        return staggered(taken, offset)
    if x:
        return random_x(taken, x, rand)
    return find_first_zero(taken)


def select_colors(nbr_colors, active, rand_u32, offset, *, max_colors: int,
                  x: int, staggered: bool) -> torch.Tensor:
    """(V, MAXD) int32 tile -> (V,) int32 colors (0 where inactive).

    ``rand_u32`` is the int32 bit pattern of uint32 draws; ``offset`` the
    per-row staggered start color.
    """
    color = _pick(taken_mask(nbr_colors, max_colors), x=x,
                  stagger=staggered, offset=offset, rand=rand_u32)
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
    order, class t as ``class_chunks[l, t]`` chunks of ``chunk`` rows of
    the step-sorted rows ``sorted_pad`` ``(P, n_local_max + chunk)``,
    against ``view``, which is updated in place and returned.
    ``class_chunks`` is ``(L, n_cls)``: the P shards are L lanes (graphs)
    of ``P / L`` shards, shard p in lane ``l = p // (P / L)``.

    Chunk j of class t starts at ``min(start[p, t] + j * chunk,
    n_local_max)``; its row i is active iff ``j < class_chunks[l, t]`` and
    ``j * chunk + i < sizes[p, t]``; the whole chunk reads the view before
    any of its colors is written.  ``nbrs`` as in ``select_run``.
    """
    n_slots = view.shape[1]
    n_local_max = nbrs[0].shape[1]
    lane = torch.arange(chunk, device=view.device)
    per_shard = class_chunks.repeat_interleave(
        view.shape[0] // class_chunks.shape[0], dim=0)
    counts = class_chunks[:, first_class:last_class + 1].amax(0).tolist()
    for t, n_chunks in enumerate(counts, start=first_class):
        for j in range(n_chunks):
            pos = (start[:, t] + j * chunk).clamp(max=n_local_max)
            active = ((lane < (sizes[:, t] - j * chunk)[:, None])
                      & (j < per_shard[:, t])[:, None])
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
                              superstep: int, lanes: int = 1):
    """The repair of one speculative round over the first ``n_steps *
    superstep`` positions of the visit order ``order_pad`` ``(P, L)``,
    chunk by chunk; returns ``(new_view, n_conflicts,
    any_boundary_conflict)``, the last two ``(lanes,)`` int64 and bool
    tensors: the P shards are ``lanes`` graphs of ``P / lanes`` shards
    each, counted apart.

    Position i of shard p is active iff its entry is ``>= 0`` and ``i <
    n_need[p]``; every chunk reads the same pre-detection ``view`` and
    writes its uncolorings into a copy.  ``nbrs`` is ``(nbr,)`` or
    ``(nbr, nbr2)``: a distance-2 row is tested against both tiles.
    """
    n_slots = view.shape[1]
    new_view = view.clone()
    n_conf = torch.zeros(lanes, dtype=torch.int64, device=view.device)
    bnd = torch.zeros(lanes, dtype=torch.bool, device=view.device)
    offs = torch.arange(superstep, device=view.device)
    test = detect_conflicts if len(nbrs) == 1 else detect_conflicts_d2
    flat = lambda t: t.reshape(-1, t.shape[-1])
    per_lane = lambda t: t.reshape(lanes, -1)
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
        n_conf = n_conf + per_lane(conf).sum(dim=1)
        bnd = bnd | per_lane(conf & ~take_rows(is_internal, r_safe)).any(1)
    return new_view, n_conf, bnd


def greedy_run(view, usage, order_pad, nbrs: tuple, rand, offset, *,
               first_step: int, n_steps: int, superstep: int,
               max_colors: int, x: int, staggered: bool,
               least_used: bool):
    """Sequential supersteps ``first_step … first_step + n_steps - 1``:
    positions ``first_step * superstep`` to ``(first_step + n_steps) *
    superstep - 1`` of ``order_pad`` ``(P, L)``, one at a time, on all P
    shards at once.  ``view`` ``(P, n_slots)`` and ``usage`` ``(P,
    max_colors)`` int32 are updated in place and returned.

    A position colors its vertex iff its entry is ``>= 0`` and the vertex's
    view color is 0, reading the view as the previous position left it: the
    colors of its ELL rows (``nbrs`` is ``(nbr,)`` or ``(nbr, nbr2)``; the
    sentinel padding holds color 0) give the taken mask; Least-Used (which
    reads ``usage``), Staggered (from ``offset`` ``(P,)``), Random-X
    (``x > 0``, the draws ``rand`` ``(P, n_local_max)``) or First Fit
    picks; the color is capped at ``max_colors - 1``, written, and counted
    in ``usage``.
    """
    n_slots = view.shape[1]
    off = None if offset is None else offset.reshape(-1)
    # a local color only ever goes from 0 to a color within a run, so a
    # position no shard could color at the start stays idle: skip it
    pos0, pos1 = first_step * superstep, (first_step + n_steps) * superstep
    rows = order_pad[:, pos0:pos1].long()
    live = ((rows >= 0) & (take_rows(view, rows.clamp(min=0)) == 0)).any(0)
    for i in (pos0 + live.nonzero()[:, 0]).tolist():
        v = order_pad[:, i:i + 1].long()                        # (P, 1)
        v_safe = v.clamp(min=0)
        active = ((v >= 0) & (view.gather(1, v_safe) == 0))[:, 0]
        cols = torch.cat([take_rows(view, take_rows(n, v_safe)[:, 0])
                          for n in nbrs], dim=1)
        draw = None if rand is None else take_rows(rand, v_safe)[:, 0]
        c = _pick(taken_mask(cols, max_colors), x=x, stagger=staggered,
                  offset=off, rand=draw,
                  usage=usage if least_used else None)
        c = c.clamp(max=max_colors - 1)
        idx = torch.where(active, v_safe[:, 0], n_slots - 1)[:, None]
        view.scatter_(1, idx,
                      torch.where(active, c, 0)[:, None].to(view.dtype))
        usage.scatter_add_(1, c[:, None], active[:, None].to(usage.dtype))
    return view, usage


def exchange_push(view, fan_ptr, fan_dst, sorted_pad, start, sizes, lane_on,
                  *, first_class: int, last_class: int, wire16: bool):
    """Store the color of every row of classes ``first_class …
    last_class`` at its ghost copies: shard p's rows are its sorted
    positions ``[start[p, first_class], start[p, last_class] + sizes[p,
    last_class])`` of ``sorted_pad``, the copies of its row v the flat view
    entries ``fan_dst[fan_ptr[p, v] : fan_ptr[p, v + 1]]``; a lane whose
    ``lane_on`` is 0 (``(L,)``, the S shards L lanes of ``S / L``; ``None``
    = all) pushes nothing.  ``view`` is updated in place and returned."""
    S = view.shape[0]
    lo = start[:, first_class].long()
    hi = (start[:, last_class] + sizes[:, last_class]).long()
    if lane_on is not None:
        on = lane_on.repeat_interleave(S // lane_on.shape[0]) != 0
        hi = torch.where(on, hi, lo)
    pos = torch.arange(sorted_pad.shape[1], device=view.device)
    p, i = ((pos >= lo[:, None]) & (pos < hi[:, None])).nonzero(
        as_tuple=True)
    v = sorted_pad[p, i].long()
    first, n = fan_ptr[p, v].long(), (fan_ptr[p, v + 1] - fan_ptr[p, v]).long()
    row = torch.repeat_interleave(torch.arange(v.numel(), device=view.device),
                                  n)
    entry = (first - (n.cumsum(0) - n))[row] + torch.arange(
        row.numel(), device=view.device)
    color = view[p, v]
    if wire16:
        color = color.to(torch.int16).to(view.dtype)
    view.view(-1)[fan_dst[entry].long()] = color[row]
    return view
