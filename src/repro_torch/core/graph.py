"""Host-side graph substrate: global CSR + distributed partitioning.

A numpy copy of the reference's ``repro.core.graph`` (halo 1 and the
two-hop halo of distance-2 coloring), kept here so the port imports no
jax, plus the host→device step (``to_device``, ``arrays_from_numpy``,
``view_from_numpy``).

The distributed layout mirrors the paper (§2.2): each processor owns a
contiguous block of vertices; for every cross-partition edge both
endpoints' processors know the edge.  Vertices whose neighbours are all
local are *internal*; the rest are *boundary*.  Remote neighbours appear
locally as *ghost* slots.

Device layout (per processor p, padded to common maxima so the arrays stack
on a leading P axis):

  view slots  = [0, n_local_max)                local vertices
              | [n_local_max, n_local_max+g)    ghosts (stale remote colors)
              | sentinel slot (always color 0)  at index n_slots-1

``nbr`` is the adjacency in padded-neighbour (ELL) form: one
``(n_local_max, maxd)`` row of slot ids per vertex, padded with the sentinel
slot, so a tile of vertices gathers its neighbourhood with one
``view[nbr[rows]]`` — the layout the selection kernels consume.
``boundary`` lists local boundary slots; only boundary colors travel.  Under
the broadcast scheme ghost g of processor p is owned by ``ghost_owner[g]``
and lives at position ``ghost_slot[g]`` of that owner's payload; under the
sparse scheme (``CommPlan``) each processor ships per-destination send lists
over a static ring-shift round schedule.

``partition_graph(..., halo=2)`` widens everything to the two-hop halo:
ghosts cover every remote vertex within two hops, ``nbr2`` holds the
strict two-hop ELL, and ``boundary``/``is_internal`` mean "read by some
other shard".  The comm plan is halo-agnostic.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Graph:
    """Global symmetric CSR graph (host, numpy)."""

    n: int
    indptr: np.ndarray  # (n+1,) int64
    indices: np.ndarray  # (2m,) int32 (int64 past the 2**31 id bound)

    @property
    def m(self) -> int:
        return int(self.indices.shape[0]) // 2

    @property
    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr).astype(np.int32)

    @property
    def max_degree(self) -> int:
        return int(self.degrees.max(initial=0))


#: per-shard slot index arrays (slots, ELL neighbours) are int32 below this.
INT32_LIMIT = 2**31
#: hard ceiling of the id layout — int64 ids cannot represent past this.
INT64_LIMIT = 2**63


@dataclasses.dataclass(frozen=True)
class IdPolicy:
    """The single id-width decision point.

    Global ids (``gvid``, ``prio``, CSR ``indices``) are int32 while
    ``n_global < 2**31`` and int64 past it; the flattened ELL index
    ``v * maxd + k`` is int32 while ``n_local_max * max(maxd, maxd2)``
    stays under 2**31.  Per-shard slot ids stay int32 regardless.
    """

    n_global: int
    ell: int                 # n_local_max * max(maxd, maxd2, 1)
    id_dtype: object         # numpy dtype for global vertex ids
    ell_dtype: object        # numpy dtype for flattened ELL indices

    @property
    def promoted(self) -> bool:
        """Either verdict is int64 (the giant-graph regime)."""
        return (np.dtype(self.id_dtype) == np.int64
                or np.dtype(self.ell_dtype) == np.int64)

    @property
    def id_itemsize(self) -> int:
        return np.dtype(self.id_dtype).itemsize


def id_policy(n_global: int, n_local_max: int, maxd: int, maxd2: int = 0,
              *, allow_int64: bool = True) -> IdPolicy:
    """Decide the id widths for a (partitioned) graph's device layout.

    Crossing either int32 bound promotes the affected dtype to int64
    (``allow_int64=False`` raises there instead, the hard int32 guard of
    ``check_int32_limits``); int64 itself overflowing is an error.
    """
    ell = n_local_max * max(maxd, maxd2, 1)
    if n_global >= INT64_LIMIT or ell >= INT64_LIMIT:
        raise ValueError(
            f"graph exceeds the int64 id range: n_global={n_global}, "
            f"n_local_max * maxd = {ell} (>= {INT64_LIMIT})")
    if not allow_int64:
        if n_global >= INT32_LIMIT:
            raise ValueError(
                f"graph has {n_global} vertices but device vertex ids are "
                f"int32 (< {INT32_LIMIT}); this exceeds the supported size")
        if ell >= INT32_LIMIT:
            raise ValueError(
                f"int32 ELL overflow: n_local_max * maxd = {n_local_max} * "
                f"{max(maxd, maxd2, 1)} = {ell} >= {INT32_LIMIT}; partition "
                f"over more workers (larger P) to shrink the per-shard tile")
    return IdPolicy(
        n_global=n_global, ell=ell,
        id_dtype=np.int64 if n_global >= INT32_LIMIT else np.int32,
        ell_dtype=np.int64 if ell >= INT32_LIMIT else np.int32)


def check_int32_limits(n_global: int, n_local_max: int, maxd: int,
                       maxd2: int = 0) -> None:
    """The hard int32 guard: raises where an int32-only layout would
    overflow (``id_policy(..., allow_int64=False)``)."""
    id_policy(n_global, n_local_max, maxd, maxd2, allow_int64=False)


def _pad2(rows: list[np.ndarray], width: int, fill: int) -> np.ndarray:
    out = np.full((len(rows), width), fill, dtype=np.int32)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
    return out


def _unique_pairs(a: np.ndarray, b: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Sort index pairs by (a, b) and drop duplicates — no packed keys."""
    order = np.lexsort((b, a))
    a, b = a[order], b[order]
    keep = np.empty(a.shape[0], dtype=bool)
    keep[:1] = True
    keep[1:] = (a[1:] != a[:-1]) | (b[1:] != b[:-1])
    return a[keep], b[keep]


def _pair_diff(a2: np.ndarray, b2: np.ndarray, a1: np.ndarray,
               b1: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Set-difference of *deduped* pair lists: (a2, b2) minus (a1, b1).

    One lexsort over the concatenation with a membership tag: a pair of the
    second list survives unless the (unique) copy from the first list sorts
    immediately before it.  Output stays sorted by (a, b).
    """
    a = np.concatenate([a1, a2])
    b = np.concatenate([b1, b2])
    tag = np.concatenate([np.zeros(a1.shape[0], bool),
                          np.ones(a2.shape[0], bool)])
    order = np.lexsort((tag, b, a))
    a, b, tag = a[order], b[order], tag[order]
    dup = np.zeros(a.shape[0], bool)
    dup[1:] = (a[1:] == a[:-1]) & (b[1:] == b[:-1])
    keep = tag & ~dup
    return a[keep], b[keep]


def _two_hop_pairs(g: Graph, lo: int, row: np.ndarray, nbrs: np.ndarray,
                   chunk_paths: int = 1 << 22
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Unique (local row, global id) pairs at graph distance exactly 2.

    Expands every length-2 path v -> w -> u from the block's vertices v (the
    middle vertex w may be local or remote), then drops u == v and the pairs
    already adjacent — the direct neighbourhood lives in ``nbr`` and the D2
    kernels OR both bitsets, so keeping strict two-hop rows only is what
    bounds the ELL width.  The expansion is chunked (a hub of degree d
    contributes d² raw paths) with an incremental dedup, so peak host memory
    tracks the deduped two-hop set plus ``chunk_paths``, not the raw path
    count.  The row order is part of ``nbr2``.
    """
    deg = (g.indptr[nbrs + 1] - g.indptr[nbrs]).astype(np.int64)
    cum = np.cumsum(deg)
    row2 = np.empty(0, np.int64)
    nb2 = np.empty(0, np.int64)
    start = 0
    while start < nbrs.shape[0]:
        base = cum[start - 1] if start else 0
        end = max(start + 1, int(np.searchsorted(cum, base + chunk_paths,
                                                 side="right")))
        end = min(end, nbrs.shape[0])
        w, d = nbrs[start:end], deg[start:end]
        starts = g.indptr[w].astype(np.int64)
        offs2 = np.cumsum(d) - d
        pos = np.arange(int(d.sum()), dtype=np.int64) - np.repeat(offs2, d)
        u = g.indices[np.repeat(starts, d) + pos].astype(np.int64)
        v = np.repeat(row[start:end].astype(np.int64), d)
        keep = u != v + lo
        row2, nb2 = _unique_pairs(np.concatenate([row2, v[keep]]),
                                  np.concatenate([nb2, u[keep]]))
        start = end
    row2, nb2 = _pair_diff(row2, nb2, row.astype(np.int64),
                           nbrs.astype(np.int64))
    return row2.astype(np.int32), nb2.astype(np.int32)


def _ceil_pow2(x: int) -> int:
    return 1 if x <= 1 else 1 << (int(x) - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class CommPlan:
    """Static sparse-exchange schedule (paper's neighbour-to-neighbour sends).

    In round ``r`` every shard p sends one buffer to ``(p + shifts[r]) % P``.
    Only shifts with traffic exist; ``widths`` are the pow2-rung padded
    buffer widths, ``exact_widths`` the true pmax payload counts (what
    ``wire_bytes`` measures).  ``send_slot[p, r]`` lists the local boundary
    slots the round-r destination reads; ghost g of shard q arrives in
    round ``shift_to_round[ghost_shift[q, g]]`` at buffer position
    ``ghost_pos[q, g]``.
    """

    shifts: tuple          # static nonzero ring shifts with any traffic
    widths: tuple          # per-shift *padded* buffer width (pow2 rung)
    exact_widths: tuple    # per-shift true pmax payload width (<= widths)
    max_send: int          # max(widths), the send_slot pad width
    n_send: np.ndarray     # (P, P) per-(src, dst) payload counts
    send_slot: np.ndarray  # (P, n_rounds, max_send) local slots, pad=sentinel
    ghost_shift: np.ndarray  # (P, max_ghost) ring shift of each ghost, pad=-1
    ghost_pos: np.ndarray    # (P, max_ghost) position in owner's send row
    shift_to_round: np.ndarray  # (P, P) shift value -> round index, -1 unused

    @property
    def static(self) -> tuple:
        """Hashable ``(shifts, padded widths)``: the round schedule's shape,
        part of a ``PlanSignature``."""
        return (self.shifts, self.widths)

    def arrays(self) -> dict[str, np.ndarray]:
        P = self.send_slot.shape[0]
        rw = np.zeros((max(len(self.shifts), 1),), np.int32)
        rw[:len(self.exact_widths)] = self.exact_widths
        return dict(send_slot=self.send_slot, ghost_shift=self.ghost_shift,
                    ghost_pos=self.ghost_pos,
                    shift_to_round=self.shift_to_round,
                    round_widths=np.broadcast_to(rw, (P, rw.shape[0])).copy())

    def bytes_per_exchange(self, itemsize: int = 4, *,
                           padded: bool = False) -> int:
        """Per-shard wire bytes of one full sparse exchange (exact plan
        widths; ``padded=True`` counts the pow2-rung buffers shipped)."""
        ws = self.widths if padded else self.exact_widths
        return int(sum(ws)) * itemsize


@dataclasses.dataclass(frozen=True)
class PartitionedGraph:
    """Per-processor padded arrays, stacked on a leading P axis (host, numpy).

    `n_slots = n_local_max + max_ghost + 1`.
    """

    P: int
    n_global: int
    n_local_max: int
    max_ghost: int
    max_boundary: int
    m_local_max: int
    maxd: int
    offs: np.ndarray           # (P+1,) block boundaries in global ids
    n_local: np.ndarray        # (P,)
    n_ghost: np.ndarray        # (P,)
    n_boundary: np.ndarray     # (P,)
    indptr: np.ndarray         # (P, n_local_max+1)
    indices: np.ndarray        # (P, m_local_max) slot ids, pad=sentinel
    nbr: np.ndarray            # (P, n_local_max, maxd) ELL slot ids, pad=sentinel
    edge_src: np.ndarray       # (P, m_local_max) local row per edge, pad=n_local_max
    boundary: np.ndarray       # (P, max_boundary) local slots, pad=sentinel
    ghost_owner: np.ndarray    # (P, max_ghost)
    ghost_slot: np.ndarray     # (P, max_ghost)
    gvid: np.ndarray           # (P, n_slots) global vertex id per slot, pad=-1
    prio: np.ndarray           # (P, n_slots) random tie-break priority, pad=-1
    is_internal: np.ndarray    # (P, n_local_max) bool
    degree: np.ndarray         # (P, n_local_max) int32 local-graph-visible degree
    halo: int = 1              # ghost depth: 1 (D1) or 2 (two-hop halo, D2)
    maxd2: int = 0             # max strict-two-hop row width (halo=2 only)
    nbr2: np.ndarray | None = None  # (P, n_local_max, maxd2) two-hop ELL
                                    # slot ids, pad=sentinel (halo=2 only)
    quantize_plan: bool = True  # pow2-rung round widths in ``comm_plan``

    @property
    def n_slots(self) -> int:
        return self.n_local_max + self.max_ghost + 1

    @property
    def sentinel(self) -> int:
        return self.n_slots - 1

    @functools.cached_property
    def comm_plan(self) -> CommPlan:
        """Sparse-exchange schedule; built once, cached on the instance."""
        return build_comm_plan(self)

    def arrays(self, *, sparse: bool = True) -> dict[str, np.ndarray]:
        """Host dict of everything the device code consumes (the
        reference's ``PartitionedGraph.arrays()`` layout)."""
        out = dict(
            n_local=self.n_local.astype(np.int32),
            indptr=self.indptr,
            indices=self.indices,
            nbr=self.nbr,
            edge_src=self.edge_src,
            boundary=self.boundary,
            ghost_owner=self.ghost_owner,
            ghost_slot=self.ghost_slot,
            prio=self.prio,
            is_internal=self.is_internal,
            degree=self.degree,
        )
        if self.nbr2 is not None:
            out["nbr2"] = self.nbr2
        if sparse:
            out.update(self.comm_plan.arrays())
        return out

    def gather_global_colors(self, local_colors: np.ndarray) -> np.ndarray:
        """(P, n_slots) or (P, n_local_max) views -> (n_global,) colors."""
        out = np.zeros(self.n_global, dtype=local_colors.dtype)
        for p in range(self.P):
            nl = int(self.n_local[p])
            out[self.offs[p] : self.offs[p] + nl] = local_colors[p, :nl]
        return out


def partition_graph(g: Graph, P: int, *, seed: int = 0,
                    permute: bool = False, halo: int = 1) -> PartitionedGraph:
    """Block-partition `g` onto P processors and build the device layout.

    ``permute=True`` applies a random vertex permutation first.

    ``halo=2`` builds the two-hop halo for distance-2 coloring: the ghost
    tables extend to every remote vertex within two hops, ``nbr2`` carries
    the strict two-hop neighbourhood in ELL form, and
    ``boundary``/``is_internal`` widen to "this color is read by some other
    shard".  Depth-2 ghosts are ordinary ghost-table entries (sorted by
    global id, hence owner-contiguous), so both exchange schemes carry
    them unchanged.
    """
    if halo not in (1, 2):
        raise ValueError(f"halo must be 1 or 2, got {halo}")
    rng = np.random.default_rng(seed)
    id_dt = id_policy(g.n, 1, 1).id_dtype
    if permute:
        perm = rng.permutation(g.n).astype(id_dt)
        inv = np.empty_like(perm)
        inv[perm] = np.arange(g.n, dtype=id_dt)
        deg = g.degrees
        new_indptr = np.zeros(g.n + 1, dtype=np.int64)
        new_indptr[1:] = np.cumsum(deg[perm])
        new_indices = np.empty_like(g.indices)
        for new_v in range(g.n):
            old_v = perm[new_v]
            s, e = g.indptr[old_v], g.indptr[old_v + 1]
            new_indices[new_indptr[new_v] : new_indptr[new_v + 1]] = inv[g.indices[s:e]]
        g = Graph(g.n, new_indptr, new_indices)

    offs = np.linspace(0, g.n, P + 1).astype(np.int64)
    owner_of = np.searchsorted(offs, np.arange(g.n), side="right") - 1
    prio_global = rng.permutation(g.n).astype(id_dt)  # random total order (§2.2)

    n_local = (offs[1:] - offs[:-1]).astype(np.int32)
    n_local_max = int(n_local.max())

    # pass 1: per-shard edge slices, halo sets (the remote vertices whose
    # colors this shard reads) and, at halo=2, the strict two-hop pair lists
    ghosts_of: list[np.ndarray] = []
    edge_of: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []
    hop2: list[tuple[np.ndarray, np.ndarray, np.ndarray] | None] = []
    for p in range(P):
        lo, hi = int(offs[p]), int(offs[p + 1])
        nl = hi - lo
        nbrs = g.indices[g.indptr[lo] : g.indptr[hi]]
        row = np.repeat(np.arange(nl, dtype=np.int32),
                        np.diff(g.indptr[lo : hi + 1]).astype(np.int32))
        remote = (nbrs < lo) | (nbrs >= hi)
        edge_of.append((nbrs, row, remote))
        if halo == 1:
            ghosts_of.append(np.unique(nbrs[remote]))
            hop2.append(None)
        else:
            row2, nb2 = _two_hop_pairs(g, lo, row, nbrs)
            rem2 = (nb2 < lo) | (nb2 >= hi)
            ghosts_of.append(np.unique(np.concatenate(
                [nbrs[remote], nb2[rem2]])))
            hop2.append((row2, nb2, rem2))

    # boundary = local vertices some other shard reads (at halo=2 this
    # widens to the two-hop fringe)
    read_remote = np.zeros(g.n, dtype=bool)
    for gh in ghosts_of:
        read_remote[gh] = True

    rows_indptr, rows_indices, rows_src = [], [], []
    rows_boundary, rows_gowner = [], []
    rows_internal, rows_degree = [], []
    n_ghost = np.zeros(P, dtype=np.int32)
    n_boundary = np.zeros(P, dtype=np.int32)

    for p in range(P):
        lo, hi = int(offs[p]), int(offs[p + 1])
        nbrs, row, remote = edge_of[p]
        gh = ghosts_of[p]
        slots = np.where(remote, 0, nbrs - lo).astype(np.int32)
        if remote.any():
            slots[remote] = (n_local_max
                             + np.searchsorted(gh, nbrs[remote])).astype(
                                 np.int32)
        is_bnd = read_remote[lo:hi].copy()
        bnd = np.nonzero(is_bnd)[0].astype(np.int32)
        n_boundary[p] = len(bnd)
        n_ghost[p] = len(gh)

        rows_indptr.append(np.diff(g.indptr[lo : hi + 1]).astype(np.int32))
        rows_indices.append(slots)
        rows_src.append(row)
        rows_boundary.append(bnd)
        gowner = owner_of[gh].astype(np.int32) if len(gh) else np.zeros(0, np.int32)
        rows_gowner.append(gowner)
        rows_internal.append(~is_bnd)
        rows_degree.append(np.diff(g.indptr[lo : hi + 1]).astype(np.int32))

    # ghost -> (owner, slot-in-owner-boundary-payload) via one global table
    bslot_global = np.full(g.n, -1, dtype=np.int32)
    for p in range(P):
        lo = int(offs[p])
        bslot_global[rows_boundary[p] + lo] = np.arange(
            len(rows_boundary[p]), dtype=np.int32)
    gslot_rows = [bslot_global[gh] for gh in ghosts_of]

    max_ghost = max(1, int(n_ghost.max()))
    max_boundary = max(1, int(n_boundary.max()))
    m_local_max = max(1, max(len(r) for r in rows_indices))
    n_slots = n_local_max + max_ghost + 1
    sentinel = n_slots - 1

    indptr = np.zeros((P, n_local_max + 1), dtype=np.int32)
    gvid = np.full((P, n_slots), -1, dtype=id_dt)
    prio = np.full((P, n_slots), -1, dtype=id_dt)
    is_internal = np.zeros((P, n_local_max), dtype=bool)
    degree = np.zeros((P, n_local_max), dtype=np.int32)
    for p in range(P):
        nl = int(n_local[p])
        indptr[p, 1 : nl + 1] = np.cumsum(rows_indptr[p])
        indptr[p, nl + 1 :] = indptr[p, nl]
        gh, lo = ghosts_of[p], int(offs[p])
        gvid[p, :nl] = np.arange(lo, lo + nl, dtype=id_dt)
        gvid[p, n_local_max : n_local_max + len(gh)] = gh
        prio[p, :nl] = prio_global[lo : lo + nl]
        prio[p, n_local_max : n_local_max + len(gh)] = prio_global[gh]
        is_internal[p, :nl] = rows_internal[p]
        degree[p, :nl] = rows_degree[p]

    indices = _pad2(rows_indices, m_local_max, sentinel)
    edge_src = _pad2(rows_src, m_local_max, n_local_max)

    # ELL form of the same adjacency, padded with the sentinel (color 0)
    maxd = max(1, max(int(r.max(initial=0)) for r in rows_indptr))
    id_policy(g.n, n_local_max, maxd)  # before the ELL allocation
    nbr = np.full((P, n_local_max, maxd), sentinel, dtype=np.int32)
    for p in range(P):
        deg_p = rows_indptr[p].astype(np.int64)
        starts = np.concatenate([[0], np.cumsum(deg_p)])[:-1]
        row = rows_src[p].astype(np.int64)
        col = np.arange(len(row), dtype=np.int64) - starts[row]
        nbr[p, row, col] = rows_indices[p]
    boundary = _pad2(rows_boundary, max_boundary, sentinel)
    ghost_owner = _pad2(rows_gowner, max_ghost, 0)
    ghost_slot = _pad2(gslot_rows, max_ghost, 0)

    # strict two-hop ELL (halo=2): nbr2[p, v, k] = k-th distance-2 slot of v.
    # Rows come sorted by (v, global id) from _two_hop_pairs, so each
    # vertex's entries are one contiguous run.
    maxd2, nbr2 = 0, None
    if halo == 2:
        slot2_rows = []
        for p in range(P):
            lo = int(offs[p])
            row2, nb2, rem2 = hop2[p]
            slot2 = np.where(rem2, 0, nb2 - lo).astype(np.int32)
            if rem2.any():
                slot2[rem2] = (n_local_max + np.searchsorted(
                    ghosts_of[p], nb2[rem2])).astype(np.int32)
            slot2_rows.append((row2, slot2))
            cnt = np.bincount(row2, minlength=1)
            maxd2 = max(maxd2, int(cnt.max(initial=0)))
        maxd2 = max(1, maxd2)
        id_policy(g.n, n_local_max, maxd, maxd2)
        nbr2 = np.full((P, n_local_max, maxd2), sentinel, dtype=np.int32)
        for p in range(P):
            row2, slot2 = slot2_rows[p]
            cnt = np.bincount(row2, minlength=n_local_max).astype(np.int64)
            starts2 = np.concatenate([[0], np.cumsum(cnt)])[:-1]
            col = np.arange(len(row2), dtype=np.int64) - starts2[row2]
            nbr2[p, row2, col] = slot2

    return PartitionedGraph(
        P=P, n_global=g.n, n_local_max=n_local_max, max_ghost=max_ghost,
        max_boundary=max_boundary, m_local_max=m_local_max, maxd=maxd,
        offs=offs, n_local=n_local, n_ghost=n_ghost, n_boundary=n_boundary,
        indptr=indptr, indices=indices, nbr=nbr, edge_src=edge_src,
        boundary=boundary, ghost_owner=ghost_owner, ghost_slot=ghost_slot,
        gvid=gvid, prio=prio, is_internal=is_internal, degree=degree,
        halo=halo, maxd2=maxd2, nbr2=nbr2,
    )


def build_comm_plan(pg: PartitionedGraph, *,
                    quantize: bool | None = None) -> CommPlan:
    """Derive the sparse neighbour-to-neighbour schedule from the ghosts.

    Shard q's ghosts are sorted by global id and block partitioning makes
    the owner monotone in the id, so the ghosts owned by one shard p form
    one contiguous run: p's send list to q.  ``quantize`` (default
    ``pg.quantize_plan``) rounds every round's buffer width up to a power
    of two; byte accounting keeps the exact widths.
    """
    P = pg.P
    n_send = np.zeros((P, P), dtype=np.int32)
    send_lists: dict[tuple[int, int], np.ndarray] = {}
    ghost_pos = np.zeros((P, pg.max_ghost), dtype=np.int32)
    ghost_shift = np.full((P, pg.max_ghost), -1, dtype=np.int32)

    for q in range(P):
        ng = int(pg.n_ghost[q])
        if ng == 0:
            continue
        owners = pg.ghost_owner[q, :ng]
        vids = pg.gvid[q, pg.n_local_max : pg.n_local_max + ng]
        starts = np.flatnonzero(np.r_[True, owners[1:] != owners[:-1]])
        ends = np.r_[starts[1:], ng]
        for s, e in zip(starts, ends):
            p = int(owners[s])
            send_lists[(p, q)] = (vids[s:e] - pg.offs[p]).astype(np.int32)
            n_send[p, q] = e - s
            ghost_pos[q, s:e] = np.arange(e - s, dtype=np.int32)
            ghost_shift[q, s:e] = (q - p) % P

    srcs, dsts = np.nonzero(n_send)
    all_shifts = (dsts - srcs) % P
    shifts = tuple(int(k) for k in np.unique(all_shifts))
    exact_widths = tuple(
        int(n_send[np.arange(P), (np.arange(P) + k) % P].max())
        for k in shifts)
    if quantize is None:
        quantize = pg.quantize_plan
    widths = (tuple(_ceil_pow2(w) for w in exact_widths) if quantize
              else exact_widths)
    max_send = max(widths, default=0)

    send_slot = np.full((P, max(len(shifts), 1), max(max_send, 1)),
                        pg.sentinel, dtype=np.int32)
    for r, k in enumerate(shifts):
        for p in range(P):
            q = (p + k) % P
            sl = send_lists.get((p, q))
            if sl is not None:
                send_slot[p, r, : len(sl)] = sl

    shift_to_round = np.full((P,), -1, dtype=np.int32)
    for r, k in enumerate(shifts):
        shift_to_round[k] = r

    return CommPlan(
        shifts=shifts, widths=widths, exact_widths=exact_widths,
        max_send=max_send, n_send=n_send,
        send_slot=send_slot, ghost_shift=ghost_shift, ghost_pos=ghost_pos,
        shift_to_round=np.broadcast_to(shift_to_round, (P, P)).copy(),
    )


# ------------------------------------------------------------ shape buckets --

def pad_partition(pg: PartitionedGraph, *, n_local_max: int | None = None,
                  max_ghost: int | None = None, max_boundary: int | None = None,
                  m_local_max: int | None = None, maxd: int | None = None,
                  maxd2: int | None = None) -> PartitionedGraph:
    """Re-pad a partition to larger target maxima (same graph, same blocks).

    The batched pipeline (``color_many``) stacks several partitions on a
    leading lane axis, so every padded dimension must agree across the
    batch.  Local slots keep their ids, ghost slots shift by ``n_local_max
    - pg.n_local_max`` and the sentinel moves to the new ``n_slots - 1``;
    new padding is inert (ELL pads point at the sentinel, ``gvid``/``prio``
    pads are -1, padded local rows have no neighbours).  Random-X draws
    depend on ``n_local_max``, so a padded run reproduces runs at the same
    padded shape, not the unpadded one.
    """
    new_nlm = pg.n_local_max if n_local_max is None else int(n_local_max)
    new_mg = pg.max_ghost if max_ghost is None else int(max_ghost)
    new_mb = pg.max_boundary if max_boundary is None else int(max_boundary)
    new_ml = pg.m_local_max if m_local_max is None else int(m_local_max)
    new_maxd = pg.maxd if maxd is None else int(maxd)
    new_maxd2 = pg.maxd2 if maxd2 is None else int(maxd2)
    if (new_nlm < pg.n_local_max or new_mg < pg.max_ghost
            or new_mb < pg.max_boundary or new_ml < pg.m_local_max
            or new_maxd < pg.maxd or new_maxd2 < pg.maxd2):
        raise ValueError("pad_partition only widens a partition")
    if (new_nlm, new_mg, new_mb, new_ml, new_maxd, new_maxd2) == (
            pg.n_local_max, pg.max_ghost, pg.max_boundary, pg.m_local_max,
            pg.maxd, pg.maxd2):
        return pg

    P = pg.P
    old_nlm, old_sent = pg.n_local_max, pg.sentinel
    new_sent = new_nlm + new_mg
    d_ghost = new_nlm - old_nlm

    def remap(a: np.ndarray) -> np.ndarray:
        """Old-layout slot ids -> new layout (locals keep, ghosts shift)."""
        out = np.where(a >= old_nlm, a + d_ghost, a)
        return np.where(a == old_sent, new_sent, out).astype(np.int32)

    def pad_axis(a: np.ndarray, axis: int, width: int, fill) -> np.ndarray:
        pad = [(0, 0)] * a.ndim
        pad[axis] = (0, width - a.shape[axis])
        return np.pad(a, pad, constant_values=fill)

    indptr = pad_axis(pg.indptr, 1, new_nlm + 1, 0)
    indptr[:, old_nlm + 1:] = indptr[:, old_nlm:old_nlm + 1]
    indices = pad_axis(remap(pg.indices), 1, new_ml, new_sent)
    edge_src = np.where(pg.edge_src == old_nlm, new_nlm, pg.edge_src)
    edge_src = pad_axis(edge_src.astype(np.int32), 1, new_ml, new_nlm)
    nbr = pad_axis(pad_axis(remap(pg.nbr), 2, new_maxd, new_sent),
                   1, new_nlm, new_sent)
    boundary = pad_axis(remap(pg.boundary), 1, new_mb, new_sent)
    ghost_owner = pad_axis(pg.ghost_owner, 1, new_mg, 0)
    ghost_slot = pad_axis(pg.ghost_slot, 1, new_mg, 0)
    gvid = np.full((P, new_sent + 1), -1, dtype=pg.gvid.dtype)
    prio = np.full((P, new_sent + 1), -1, dtype=pg.prio.dtype)
    gvid[:, :old_nlm] = pg.gvid[:, :old_nlm]
    gvid[:, new_nlm:new_nlm + pg.max_ghost] = pg.gvid[:, old_nlm:old_sent]
    prio[:, :old_nlm] = pg.prio[:, :old_nlm]
    prio[:, new_nlm:new_nlm + pg.max_ghost] = pg.prio[:, old_nlm:old_sent]
    is_internal = pad_axis(pg.is_internal, 1, new_nlm, False)
    degree = pad_axis(pg.degree, 1, new_nlm, 0)
    nbr2 = None
    if pg.nbr2 is not None:
        nbr2 = pad_axis(pad_axis(remap(pg.nbr2), 2, max(new_maxd2, 1),
                                 new_sent), 1, new_nlm, new_sent)

    return dataclasses.replace(
        pg, n_local_max=new_nlm, max_ghost=new_mg, max_boundary=new_mb,
        m_local_max=new_ml, maxd=new_maxd, maxd2=new_maxd2,
        indptr=indptr, indices=indices, nbr=nbr, edge_src=edge_src,
        boundary=boundary, ghost_owner=ghost_owner, ghost_slot=ghost_slot,
        gvid=gvid, prio=prio, is_internal=is_internal, degree=degree,
        nbr2=nbr2)


def plan_fits(plan: CommPlan, static: tuple) -> bool:
    """True iff ``plan`` embeds into the target ``(shifts, widths)``
    schedule: each of its ring shifts exists there with a buffer at least
    as wide."""
    shifts, widths = static
    w = dict(zip(shifts, widths))
    return all(k in w and pw <= w[k]
               for k, pw in zip(plan.shifts, plan.widths))


def remap_plan_arrays(pg, static: tuple) -> dict[str, np.ndarray]:
    """``pg``'s sparse-plan arrays re-laid onto a target static schedule.

    Rounds ``pg`` has no traffic on get an all-sentinel send row and a
    zero in ``round_widths``, so the round moves nothing of this graph and
    its wire bytes stay those of ``pg``'s own exact plan.  Raises
    ``ValueError`` when ``plan_fits`` is False.
    """
    shifts, widths = static
    pl = pg.comm_plan
    if not plan_fits(pl, static):
        raise ValueError(f"comm plan {pl.static} does not fit the target "
                         f"schedule {static}")
    P = pg.P
    max_send = max(widths, default=0)
    n_rounds = max(len(shifts), 1)
    s2r = np.full((P,), -1, dtype=np.int32)
    for r, k in enumerate(shifts):
        s2r[k] = r
    w = dict(zip(pl.shifts, pl.widths))
    ex = dict(zip(pl.shifts, pl.exact_widths))
    send = np.full((P, n_rounds, max(max_send, 1)), pg.sentinel, np.int32)
    rw = np.zeros((n_rounds,), np.int32)
    for r, k in enumerate(shifts):
        if k in w:
            rm = pl.shifts.index(k)
            send[:, r, :pl.send_slot.shape[2]] = pl.send_slot[:, rm]
            rw[r] = ex[k]
    return dict(
        send_slot=send, ghost_shift=pl.ghost_shift, ghost_pos=pl.ghost_pos,
        shift_to_round=np.broadcast_to(s2r, (P, P)).copy(),
        round_widths=np.broadcast_to(rw, (P, n_rounds)).copy())


def _union_comm_arrays(members) -> tuple[tuple, list[dict[str, np.ndarray]]]:
    """One shared sparse round schedule for a bucket of padded partitions:
    the union of the members' ring shifts, each at the widest member's
    buffer width, and every member's plan arrays re-laid onto it
    (``remap_plan_arrays``).  Returns ``((shifts, widths), per-member
    array dicts)``."""
    plans = [m.comm_plan for m in members]
    width_of = [dict(zip(pl.shifts, pl.widths)) for pl in plans]
    shifts = tuple(sorted({k for pl in plans for k in pl.shifts}))
    widths = tuple(max(w.get(k, 0) for w in width_of) for k in shifts)
    static = (shifts, widths)
    return static, [remap_plan_arrays(m, static) for m in members]


@dataclasses.dataclass(frozen=True)
class GraphBucket:
    """Same-shape padded partitions, stackable on a leading lane axis.

    Built by ``bucket_graphs``.  ``members[j]`` is the padded partition of
    input graph ``indices[j]``; every padded dimension agrees across
    members, so ``stacked_arrays`` returns ``(B, P, …)`` arrays.  The
    sparse schedule is the members' union (``plan_static``), with
    per-member ``round_widths`` keeping each graph's wire bytes exact.
    """

    indices: tuple   # positions of the members in the bucket_graphs() input
    members: tuple   # PartitionedGraph instances, padded to shared dims

    @property
    def B(self) -> int:
        return len(self.members)

    @property
    def P(self) -> int:
        return self.members[0].P

    @functools.cached_property
    def _union_plan(self) -> tuple[tuple, list[dict[str, np.ndarray]]]:
        return _union_comm_arrays(self.members)

    @property
    def plan_static(self) -> tuple:
        """The shared ``(shifts, widths)`` schedule."""
        return self._union_plan[0]

    def member_arrays(self, j: int, *, sparse: bool = True) -> dict:
        """Host dict of member ``j`` under the shared comm schedule."""
        out = self.members[j].arrays(sparse=False)
        if sparse:
            out = dict(out, **self._union_plan[1][j])
        return out

    def stacked_arrays(self, *, sparse: bool = True) -> dict[str, np.ndarray]:
        """All members stacked on a leading lane axis: ``(B, P, …)``,
        cached per ``sparse`` flag."""
        cache = self.__dict__.setdefault("_stacked", {})
        if sparse not in cache:
            per = [self.member_arrays(j, sparse=sparse)
                   for j in range(self.B)]
            cache[sparse] = {k: np.stack([d[k] for d in per])
                             for k in per[0]}
        return cache[sparse]


def bucket_graphs(pgs, *, round_pow2: bool = True) -> list:
    """Group partitioned graphs into shape buckets for batched execution.

    Bucket key: ``(P, halo, n_local_max, maxd, maxd2)``, the size-like
    dims rounded up to the next power of two (``round_pow2=True``) so
    near-sized graphs share a bucket; ``round_pow2=False`` groups only
    exactly matching dims.  Every member is re-padded (``pad_partition``)
    to the bucket's dims; ``max_ghost``/``max_boundary``/``m_local_max``
    take the member max (pow2-rounded by default).  Returns ``GraphBucket``
    objects covering the input exactly, in key order.
    """
    rnd = _ceil_pow2 if round_pow2 else int
    groups: dict[tuple, list[int]] = {}
    for i, pg in enumerate(pgs):
        key = (pg.P, pg.halo, rnd(pg.n_local_max), rnd(pg.maxd),
               rnd(pg.maxd2) if pg.halo == 2 else 0)
        groups.setdefault(key, []).append(i)
    buckets = []
    for key in sorted(groups):
        idx = groups[key]
        mem = [pgs[i] for i in idx]
        members = tuple(pad_partition(
            m, n_local_max=key[2], maxd=key[3],
            maxd2=key[4] if key[1] == 2 else 0,
            max_ghost=rnd(max(x.max_ghost for x in mem)),
            max_boundary=rnd(max(x.max_boundary for x in mem)),
            m_local_max=rnd(max(x.m_local_max for x in mem))) for m in mem)
        buckets.append(GraphBucket(indices=tuple(idx), members=members))
    return buckets


# --------------------------------------------------------- host -> device --

def arrays_from_numpy(arrs: dict, device) -> dict[str, torch.Tensor]:
    """A ``PartitionedGraph.arrays()``-layout numpy dict -> device tensors.

    Takes the dict of this module's ``PartitionedGraph.arrays()`` or the
    reference's (the two are array-for-array equal), so a reference
    partition can be fed to the port unchanged.  Dtypes are kept.
    """
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in arrs.items()}


def to_device(pg: PartitionedGraph, device, *,
              sparse: bool = True) -> dict[str, torch.Tensor]:
    """The device dict of ``pg`` (``sparse=False`` skips the comm plan)."""
    return arrays_from_numpy(pg.arrays(sparse=sparse), device)


def bucket_to_device(bucket: GraphBucket, device, *, sparse: bool = True,
                     n_lanes: int | None = None) -> dict[str, torch.Tensor]:
    """The lane-batched device dict of ``bucket``: every array ``(L·P, …)``,
    lane ``l`` holding member ``l``'s shards (lanes past ``bucket.B`` repeat
    member 0; ``n_lanes`` defaults to ``B``).  Each member's arrays are
    copied straight into their lane's rows (no stacked host copy), and
    the dict is cached on the bucket instance per ``(sparse, n_lanes,
    device)``: a bucket colored again does not copy its arrays again."""
    n_lanes = bucket.B if n_lanes is None else int(n_lanes)
    if n_lanes < bucket.B:
        raise ValueError(f"{n_lanes} lanes cannot hold {bucket.B} members")
    device = torch.device(device)
    cache = bucket.__dict__.setdefault("_device_arrays", {})
    key = (sparse, n_lanes, str(device))
    if key not in cache:
        P = bucket.P
        out = {}
        for j in range(bucket.B):
            for k, v in bucket.member_arrays(j, sparse=sparse).items():
                v = torch.from_numpy(np.ascontiguousarray(v))
                if k not in out:
                    out[k] = torch.empty((n_lanes * P,) + v.shape[1:],
                                         dtype=v.dtype, device=device)
                out[k][j * P:(j + 1) * P].copy_(v)
        for t in out.values():
            for j in range(bucket.B, n_lanes):
                t[j * P:(j + 1) * P].copy_(t[:P])
        cache[key] = out
    return cache[key]


def view_from_numpy(view, device) -> torch.Tensor:
    """A ``(P, n_slots)`` color view (numpy or reference array) -> device
    int32 tensor."""
    return torch.from_numpy(np.array(view, dtype=np.int32)).to(device)
