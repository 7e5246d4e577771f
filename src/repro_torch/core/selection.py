"""Color-selection strategies (paper §2.1, §3.2): their names, and their
plain row-wise forms.

The reference's ``repro.core.selection`` works on one vertex's forbidden
bitset at a time; here each strategy takes a ``(rows, max_colors)`` bool
``taken`` mask (``taken_mask``: column ``c`` set iff a neighbour holds
color ``c``; column 0 always set, colors are 1-based) and returns one
color per row.  This module is their public surface and owns nothing:
the names live in ``kernels.ops`` (which the package itself reads) and
the forms in ``kernels/ref.py``, whose plain versions of the kernels
(``select_colors``, ``greedy_run``) run on them.

Strategies:
  FIRST_FIT   — smallest permissible color (Alg. 1).
  STAGGERED   — First Fit from a per-processor offset, wrapping to First
                Fit when nothing at or above it is free.
  LEAST_USED  — the permissible already-open color (``usage > 0``) used
                least so far on this shard, ties to the smaller color;
                First Fit when no open color is permissible.  Sequential
                by nature: it reads the running usage histogram.
  RANDOM_X    — the ``rand % n_free``-th of the X smallest permissible
                colors (Gebremedhin et al.; the paper's initial coloring).

Color ``max_colors - 1`` is the saturation sentinel: never free, and
returned when no color is permissible.
"""
from repro_torch.kernels.ops import (FIRST_FIT, LEAST_USED, RANDOM_X,
                                     STAGGERED, STRATEGIES)
from repro_torch.kernels.ref import (find_first_zero, least_used, random_x,
                                     staggered, taken_mask)

__all__ = ["FIRST_FIT", "LEAST_USED", "RANDOM_X", "STAGGERED", "STRATEGIES",
           "find_first_zero", "least_used", "random_x", "staggered",
           "taken_mask"]
