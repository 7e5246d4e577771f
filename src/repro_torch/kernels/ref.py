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
"""
from __future__ import annotations

import torch


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
