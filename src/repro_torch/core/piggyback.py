"""Message accounting for the piggybacking study (paper §3.1, Fig. 4): a
numpy copy of ``repro.core.piggyback``.

The paper counts MPI point-to-point messages between processor pairs during
one recoloring iteration:

  base scheme     — every processor sends one message per color step to every
                    neighbouring processor (including *empty* messages, which
                    the paper's Fig. 1 highlights).
  piggybacked     — processor P1 sends to P2 only at the last step before P2
                    first needs any pending color ("the color step before the
                    step where P2 needs any of the information contained in
                    the whole buffer"), plus one deferred end-of-iteration
                    message if anything remains.

On one device the pairwise sends become boundary gathers, so the *runtime*
win is exchange elision (see recolor.py); this module reproduces the
paper's message-count accounting analytically from the same schedule, per
pair, so Fig. 4's ≈80% message-reduction claim can be checked directly.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .graph import PartitionedGraph


@dataclasses.dataclass(frozen=True)
class MessageStats:
    n_pairs: int                 # ordered neighbouring (sender, receiver) pairs
    base_total: int              # base: one msg per pair per step
    base_nonempty: int           # base msgs that actually carry colors
    base_empty: int
    pig_total: int               # piggybacked msgs (incl. end-of-iteration)
    collective_steps_base: int   # all-gather count without coalescing (=K)
    collective_steps_pig: int    # all-gather count with coalescing

    @property
    def message_reduction(self) -> float:
        return 1.0 - self.pig_total / max(self.base_total, 1)

    @property
    def nonempty_reduction(self) -> float:
        return 1.0 - self.pig_total / max(self.base_nonempty, 1)

    @property
    def collective_reduction(self) -> float:
        return 1.0 - self.collective_steps_pig / max(self.collective_steps_base, 1)


def message_stats(pg: PartitionedGraph, colors: np.ndarray,
                  rank_of_color: np.ndarray) -> MessageStats:
    """Count base vs piggybacked messages for one RC iteration.

    `colors` is the seed coloring (n_global,), `rank_of_color[c]` the step of
    class c (1-based; rank_of_color[0] ignored).
    """
    K = int(rank_of_color.max(initial=0))
    step = rank_of_color[colors]                       # (n_global,) step per vtx
    owner = np.searchsorted(pg.offs, np.arange(pg.n_global), side="right") - 1

    # Collect all cross edges (u_owner != v_owner) once, as (pu, pv, su, sv).
    pairs_sender: dict[tuple[int, int], np.ndarray] = {}
    cross_su, cross_sv, cross_pu, cross_pv = [], [], [], []
    for p in range(pg.P):
        nl = int(pg.n_local[p])
        lo = int(pg.offs[p])
        indptr, indices = pg.indptr[p], pg.indices[p]
        m = indptr[nl]
        src = pg.edge_src[p, :m]
        dst = indices[:m]
        ghost = dst >= pg.n_local_max
        if not ghost.any():
            continue
        gidx = dst[ghost] - pg.n_local_max
        u_global = lo + src[ghost]                      # local writer/reader
        v_global = pg.gvid[p, pg.n_local_max + gidx]    # remote endpoint
        cross_pu.append(np.full(u_global.shape, p))
        cross_pv.append(owner[v_global])
        cross_su.append(step[u_global])
        cross_sv.append(step[v_global])
    if not cross_pu:
        return MessageStats(0, 0, 0, 0, 0, K, K)
    pu = np.concatenate(cross_pu)
    pv = np.concatenate(cross_pv)
    su = np.concatenate(cross_su)
    sv = np.concatenate(cross_sv)

    # --- base scheme: sender p1 -> receiver p2 at end of every step 1..K.
    pair_ids = np.unique(pu.astype(np.int64) * pg.P + pv)
    n_pairs = len(pair_ids)
    base_total = n_pairs * K
    # non-empty base msg at (p1->p2, step t): p1 colored a boundary vertex at
    # step t that p2 can see (i.e., edge (u in p1, v in p2) with step[u] = t).
    nonempty = np.unique((pu.astype(np.int64) * pg.P + pv) * (K + 1) + su)
    base_nonempty = len(nonempty)

    # --- piggybacked: for each (p1->p2), send at step min over pending deps.
    # p2 needs u's color (u in p1) before step sv (reader side), i.e. at step
    # sv-1, only when sv > su; later-read colors defer to iteration end.
    dep = sv > su
    pig_msgs = 0
    deferred_pairs = 0
    pair_key = pu.astype(np.int64) * pg.P + pv
    for pk in pair_ids:
        m = pair_key == pk
        send_steps = np.unique(sv[m & dep] - 1)        # just-in-time sends
        pig_msgs += len(send_steps)
        # anything with sv <= su is only needed next iteration -> one deferred
        # message at iteration end, unless it can piggyback on a later send.
        has_defer = (m & ~dep).any()
        last_assign = su[m].max(initial=0)
        if has_defer and (len(send_steps) == 0 or send_steps.max(initial=0)
                          < last_assign):
            deferred_pairs += 1
    pig_total = pig_msgs + deferred_pairs

    # --- collective view (what the exchange executes): one all-gather per
    # needed step, OR-reduced over pairs, + the end-of-iteration gather.
    need_steps = np.unique(sv[dep] - 1)
    collective_pig = len(np.setdiff1d(need_steps, [K])) + 1
    return MessageStats(
        n_pairs=n_pairs, base_total=base_total, base_nonempty=base_nonempty,
        base_empty=base_total - base_nonempty, pig_total=pig_total,
        collective_steps_base=K, collective_steps_pig=collective_pig,
    )
