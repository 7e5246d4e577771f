"""Distributed synchronous recoloring (paper §3), all shards on one device.

The reference's ``repro.core.recolor`` over ``(P, …)`` tensors.  Given a
valid coloring with K classes, one iteration recolors in K steps: step t
first-fit-colors the whole class ranked t — an independent set, so the step
is data-parallel and conflict-free.  Vertices are sorted by step once and
each class is consumed as fixed-size chunks; per-class chunk counts are
maxed over shards, so every shard runs the same schedule.  Every class up
to the next exchange event is one call of ``kernels.ops.recolor_run``,
which colors its chunks in order (one kernel launch on the card).

Piggybacking (§3.1): a ghost color written at step s is only read at a
later step t, so the boundary exchange after s is deferred to t-1 and
everything pending rides one exchange; under the sparse scheme the
schedule is refined per ring-shift round.  On one device the exchange at
an event is a push (``FlatExchange.push``): the vertices of the run that
just ended store their colors at their ghost copies, so each ghost is
written once an iteration.  A reader at step t of a writer at step s < t
finds the color as the pull gives it (an event falls in [s, t-1], and the
push lands at the first event at or after s); one at t <= s reads 0 as
it does there, so every run reads what the pull gives it.  Every other
exchange object (a mesh's ``MeshExchange``) keeps the pull.

The schedule (the class count, chunks per class and exchange events) is
computed on the device and read to the host once per iteration; the chunk
loop then runs with host-known bounds and exchange decisions.

A batch of L same-shape graphs (lanes, laid end to end on the shard axis:
``color_many``'s buckets) runs one iteration together: each lane has its
own class sizes, rank, class count, chunk counts (``class_chunks`` ``(L,
n_cls)``) and exchange events; the launches split at the union of the
lanes' events, and each event exchanges only its own lanes.  Classes past
a lane's class count, and chunks past a shard's class size, color nothing.  Class
permutations: RV, NI, ND and RAND (``rng.permutation``), and the
ND-RAND%x / ND-RAND%2^i schedules of ``recolor_iterations``.

Asynchronous recoloring (aRC, ``arc_sim``): each shard orders its
vertices locally by class step and reruns the speculative coloring from
an empty view (conflicts possible, hence its repair rounds).

Distance 2 (``RecolorConfig(distance=2)`` on a ``halo=2`` partition): a
class of a valid D2 coloring is a distance-2 independent set, so the step
stays conflict-free; selection ORs the two-hop colors
(``ops.recolor_run_d2``) and the piggyback schedule gains the two-hop ELL
rows as a second dependency source (``_cross_deps_ell``).  Partial seed
colorings need no flag: unmarked vertices are class 0, which the step loop
skips.
"""
from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch

from repro_torch import rng, tracing
from repro_torch.kernels import ops
from repro_torch.kernels.ref import take_rows

from .comm import (AUTO, DEFAULT_SCHEME, SCHEME_CHOICES, SPARSE, AxisComm,
                   CommConfig, FlatExchange, make_exchange, run_sharded,
                   sparse_rounds)
from .graph import PartitionedGraph, to_device
from .speculative import (ColorConfig, color_shards, require_halo,
                          resolve_cfg, resolve_device, validate_color_bounds)

RV = "rv"
NI = "ni"
ND = "nd"
RAND = "rand"
ALL_PERMS = (RV, NI, ND, RAND)
PERM_IDS = {kind: i for i, kind in enumerate(ALL_PERMS)}
INT32_MAX = 2**31 - 1

# Key-less calls fold a per-call count into the config seed, so two of
# them never replay one RAND permutation.  The count is this process's own
# (the reference keeps another), so only calls with an explicit key= can
# be held bitwise to the reference.
_DEFAULT_KEY_CALLS = itertools.count()


def _default_key(seed: int) -> torch.Tensor:
    return rng.fold_in(rng.key(seed), next(_DEFAULT_KEY_CALLS))


@dataclasses.dataclass(frozen=True)
class RecolorConfig:
    """Static configuration of one recoloring iteration.

    ``max_colors`` bounds the *seed* coloring's ids (32-aligned);
    ``chunk`` is vertices selected per ELL tile (clamped to the shard's
    row count).  ``distance=2`` needs a ``halo=2`` partition and a valid
    distance-2 seed coloring.
    """

    max_colors: int = 1024         # bound on colors of the SEED coloring
    piggyback: bool = True         # paper §3.1 (False = exchange every step)
    scheme: str = DEFAULT_SCHEME   # "sparse" | "allgather" | "auto"
    wire16: bool = False           # int16 boundary payloads
    chunk: int = 256               # vertices selected per chunk (ELL tile rows)
    backend: str = "auto"          # kernels.ops backend: auto | torch | cuda
    distance: int = 1
    seed: int = 0

    def __post_init__(self):
        validate_color_bounds(self.max_colors, self.wire16, self.backend)
        if self.scheme not in SCHEME_CHOICES:
            raise ValueError(f"bad scheme {self.scheme!r}")
        if self.chunk <= 0:
            raise ValueError("chunk must be > 0")
        if self.distance not in (1, 2):
            raise ValueError(f"bad distance {self.distance}, want 1 or 2")

    @property
    def comm_config(self) -> CommConfig:
        return CommConfig(scheme=self.scheme, wire16=self.wire16)


def class_sizes(view, n_local, n_local_max: int, max_colors: int,
                lanes: int | None = None, comm=None):
    """Global color-class sizes ``(max_colors,)`` and the count of local
    colors outside ``[0, max_colors)`` (masked out of the sizes), both on
    the device.  Class 0 (uncolored) counts 0.  With ``lanes=L`` the view
    holds L graphs of ``P / L`` shards each, and the results are ``(L,
    max_colors)`` and ``(L,)``: one row per graph.  ``comm`` (a
    ``MeshComm`` on a mesh) reduces over the lanes' shards."""
    L = 1 if lanes is None else lanes
    if comm is None:
        comm = AxisComm(view.shape[0] // L, L)
    mc = max_colors
    raw = view[:, :n_local_max]
    valid = (torch.arange(n_local_max, device=view.device)
             < n_local[:, None])
    in_range = (raw >= 0) & (raw < mc)
    oor = comm.psum((valid & ~in_range).sum(dim=1))
    counted = valid & in_range
    idx = comm.lane(view.device)[:, None] * mc + torch.where(counted, raw, 0)
    sizes = torch.zeros(L * mc, dtype=torch.int64, device=view.device)
    sizes.scatter_add_(0, idx.reshape(-1), counted.reshape(-1).long())
    sizes = comm.lane_psum(sizes.view(L, mc))
    sizes[:, 0] = 0
    return (sizes[0], oor[0]) if lanes is None else (sizes, oor)


def permutation_rank(sizes, kind, key=None) -> torch.Tensor:
    """rank[c] = recoloring step (1-based) of color class c; 0 for absent
    classes and class 0.  Ties break by color id; empty classes sort last.
    RAND ranks by ``rng.permutation(key, max_colors)`` (one key for all
    shards: the rank is global).  ``sizes`` ``(..., max_colors)`` with keys
    ``(..., 2)``: one rank per graph of a batch.

    ``kind`` is one permutation for every graph, or for ``(L,
    max_colors)`` sizes a sequence of L kinds, one per graph (the lanes
    of a serving engine sit at their own iterations): each kind present
    ranks every row, and each row takes its own kind's rank, as the
    reference's narrowed ``lax.switch`` does under ``vmap``.
    """
    if not isinstance(kind, str):
        kinds = list(kind)
        if len(kinds) != sizes.shape[0]:
            raise ValueError(f"{len(kinds)} kinds for {sizes.shape[0]} lanes")
        present = sorted(set(kinds), key=ALL_PERMS.index)
        rank = permutation_rank(sizes, present[0],
                                key if present[0] == RAND else None)
        for k in present[1:]:
            rows = torch.tensor([x == k for x in kinds], device=sizes.device)
            rank = torch.where(rows[:, None], permutation_rank(
                sizes, k, key if k == RAND else None), rank)
        return rank
    mc = sizes.shape[-1]
    colors = torch.arange(mc, device=sizes.device)
    present = (sizes > 0) & (colors > 0)
    if kind == RV:
        key_v = (-colors).expand(sizes.shape)
    elif kind == NI:
        key_v = -sizes
    elif kind == ND:
        key_v = sizes
    elif kind == RAND:
        if key is None:
            raise ValueError("the RAND permutation needs a key")
        key_v = rng.permutation(key, mc).to(sizes.device)
    else:
        raise ValueError(f"unknown permutation {kind!r}")
    key_v = torch.where(present, key_v, INT32_MAX)
    order = torch.argsort(key_v, dim=-1, stable=True)  # stable: color tie-break
    rank = torch.zeros(sizes.shape, dtype=torch.int64, device=sizes.device)
    rank.scatter_(-1, order, torch.arange(
        1, mc + 1, device=sizes.device).expand(sizes.shape))
    return torch.where(present, rank, 0)


def _cross_deps(step_of, arrs, n_local_max: int):
    """Per cross edge: (dep mask, reader step s_v, ghost index of the
    writer).  A dependency exists where the local reader reads a ghost
    whose writer recolors at an earlier step."""
    src, dst = arrs["edge_src"], arrs["indices"]
    P = step_of.shape[0]
    step_rows = torch.cat(
        [step_of[:, :n_local_max],
         torch.zeros((P, 1), dtype=step_of.dtype, device=step_of.device)],
        dim=1)
    s_v = take_rows(step_rows, src)
    s_u = take_rows(step_of, dst)
    n_ghost_cols = step_of.shape[1] - 1 - n_local_max
    is_ghost = (dst >= n_local_max) & (dst < step_of.shape[1] - 1)
    dep = is_ghost & (s_u > 0) & (s_v > s_u)
    # sentinel/local entries never form a dependency; clamp their ghost
    # index into range (the reference's gather clamps the same way)
    return dep, s_v, (dst - n_local_max).clamp(0, n_ghost_cols - 1)


def _cross_deps_ell(step_of, nbr2, n_local_max: int):
    """Cross deps over the flattened two-hop ELL rows (distance-2 readers).

    A D2 reader also consumes its two-hop ghosts' colors, so those pairs
    constrain the piggyback schedule exactly like the CSR cross edges;
    padded entries point at the sentinel (step 0) and never form one.
    """
    P = step_of.shape[0]
    dst = nbr2.reshape(P, -1)
    s_v = step_of[:, :n_local_max].repeat_interleave(nbr2.shape[2], dim=1)
    s_u = take_rows(step_of, dst)
    n_ghost_cols = step_of.shape[1] - 1 - n_local_max
    is_ghost = (dst >= n_local_max) & (dst < step_of.shape[1] - 1)
    dep = is_ghost & (s_u > 0) & (s_v > s_u)
    return dep, s_v, (dst - n_local_max).clamp(0, n_ghost_cols - 1)


def _dep_sources(step_of, arrs, n_local_max: int, distance: int):
    """All (dep, s_v, ghost index) contributions the piggyback schedule
    sees: the CSR cross edges, and at distance 2 the two-hop ELL rows."""
    deps = [_cross_deps(step_of, arrs, n_local_max)]
    if distance == 2:
        deps.append(_cross_deps_ell(step_of, arrs["nbr2"], n_local_max))
    return deps


def _needed_exchanges(step_of, arrs, n_local_max: int, n_classes,
                      max_colors: int, piggyback: bool, comm: AxisComm,
                      distance: int = 1):
    """The piggybacking schedule per lane: needed[l, t] = exchange event
    after step t, the OR over the lane's shards.  Entry ``max_colors`` is
    the end-of-iteration exchange (always on)."""
    dev = step_of.device
    L = comm.L
    if piggyback:
        # OR over each lane's dependencies; non-dependencies write to a
        # spare last entry (no mask indexing: it would sync the device)
        needed = torch.zeros((L, max_colors + 2), dtype=torch.bool,
                             device=dev)
        lane = comm.lane(dev)[:, None]
        for dep, s_v, _ in _dep_sources(step_of, arrs, n_local_max,
                                        distance):
            needed[lane.expand(dep.shape),
                   torch.where(dep, s_v - 1, max_colors + 1)] = True
        needed = comm.lane_pmax(needed[:, :max_colors + 1])
        needed[:, 0] = False
    else:
        needed = (torch.arange(max_colors + 1, device=dev)[None]
                  <= n_classes[:, None])
    needed[:, max_colors] = True
    return needed


def _needed_exchange_rounds(step_of, arrs, n_local_max: int, n_classes,
                            max_colors: int, piggyback: bool,
                            n_rounds: int, comm: AxisComm,
                            distance: int = 1):
    """Sparse piggybacking per lane: needed[l, t, r] = ring-shift round r
    after step t (each dependency marks only its writer's round).  Row
    ``max_colors`` runs every round."""
    dev = step_of.device
    P, L = comm.P, comm.L
    if piggyback:
        needed = torch.zeros((L, max_colors + 2, max(n_rounds, 1)),
                             dtype=torch.bool, device=dev)
        p = comm.index(dev)[:, None]
        lane = comm.lane(dev)[:, None]
        for dep, s_v, gi in _dep_sources(step_of, arrs, n_local_max,
                                         distance):
            shift = (p - take_rows(arrs["ghost_owner"], gi).long()) % P
            rnd = take_rows(arrs["shift_to_round"], shift)
            needed[lane.expand(dep.shape),
                   torch.where(dep, s_v - 1, max_colors + 1),
                   torch.where(dep, rnd, 0).long()] = True
        needed = comm.lane_pmax(needed[:, :max_colors + 1, :n_rounds])
        needed[:, 0] = False
    else:
        needed = (torch.arange(max_colors + 1, device=dev)[None]
                  <= n_classes[:, None])[:, :, None].expand(
                      L, max_colors + 1, n_rounds).clone()
    needed[:, max_colors] = True
    return needed


@dataclasses.dataclass
class _Schedule:
    """One iteration's chunk schedule for L lanes: the host part (class
    counts and exchange events) and the device part (int32) the chunk runs
    read."""

    n_classes: list              # per lane
    needed: np.ndarray           # (L, mc + 1) event after step t (mc = end)
    needed_rounds: np.ndarray | None  # (L, mc + 1, R) sparse: its rounds
    sorted_pad: torch.Tensor     # (L·P, n_local_max + chunk) step-sorted rows
    start_local: torch.Tensor    # (L·P, mc + 1) first sorted position of t
    local_sizes: torch.Tensor    # (L·P, mc + 1) rows of class t per shard
    class_chunks: torch.Tensor   # (L, mc + 1) chunks of class t per lane

    def events(self, lane: int) -> list:
        """The steps after which ``lane`` exchanges: its needed events up to
        its class count, and its last class."""
        n = self.n_classes[lane]
        ts = (np.flatnonzero(self.needed[lane, 1:n + 1]) + 1).tolist()
        return ts if not n or ts[-1:] == [n] else ts + [n]


def recolor_schedule(arrs, view, rank, n_classes, cfg: RecolorConfig,
                     n_rounds: int, comm=None) -> _Schedule:
    """Step map, piggyback events and per-class chunk schedule of one
    iteration; ends with its one device->host read.

    ``rank`` ``(L, max_colors)`` and ``n_classes`` ``(L,)`` give L lanes
    (the view holds their ``L·P`` shards).  A one-graph call passes
    ``(max_colors,)`` and a scalar, and gets a schedule with a python-int
    class count, ``(mc + 1,)`` event rows and ``(mc + 1,)`` chunk counts.
    ``comm`` (a ``MeshComm`` on a mesh) reduces over the lanes' shards, so
    the read is the same on every shard.
    """
    sched = _lane_schedule(arrs, view, rank.reshape(-1, rank.shape[-1]),
                           n_classes.reshape(-1), cfg, n_rounds, comm)
    return sched if rank.dim() == 2 else dataclasses.replace(
        sched, n_classes=sched.n_classes[0], needed=sched.needed[0],
        needed_rounds=(None if sched.needed_rounds is None
                       else sched.needed_rounds[0]),
        class_chunks=sched.class_chunks[0])


def _lane_schedule(arrs, view, rank, n_classes, cfg: RecolorConfig,
                   n_rounds: int, comm=None) -> _Schedule:
    """``recolor_schedule`` of ``(L, max_colors)`` ranks."""
    require_halo(arrs, cfg.distance)
    L = rank.shape[0]
    LP, n_slots = view.shape
    if comm is None:
        comm = AxisComm(LP // L, L)
    n_local_max = arrs["indptr"].shape[1] - 1
    mc = cfg.max_colors
    chunk = min(cfg.chunk, n_local_max)
    dev = view.device
    step_of = comm.per_shard(rank).gather(1, view.long().clamp(0, mc - 1))
    step_of[:, n_slots - 1] = 0                        # sentinel
    if cfg.scheme == SPARSE:
        needed_rounds = _needed_exchange_rounds(
            step_of, arrs, n_local_max, n_classes, mc, cfg.piggyback,
            n_rounds, comm, cfg.distance)
        needed = needed_rounds.any(dim=2)
        needed[:, mc] = True
    else:
        needed_rounds = None
        needed = _needed_exchanges(step_of, arrs, n_local_max, n_classes, mc,
                                   cfg.piggyback, comm, cfg.distance)

    valid_local = (torch.arange(n_local_max, device=dev)
                   < arrs["n_local"][:, None])
    sort_key = torch.where(valid_local, step_of[:, :n_local_max], mc + 1)
    sorted_rows = torch.argsort(sort_key, dim=1, stable=True)
    sorted_pad = torch.cat(
        [sorted_rows, torch.zeros((LP, chunk), dtype=torch.int64,
                                  device=dev)], dim=1)
    local_sizes = torch.zeros((LP, mc + 2), dtype=torch.int64, device=dev)
    local_sizes.scatter_add_(1, sort_key, torch.ones_like(sort_key))
    local_sizes = local_sizes[:, :mc + 1]
    start_local = local_sizes.cumsum(dim=1) - local_sizes
    max_sizes = comm.pmax(local_sizes)
    t = torch.arange(mc + 1, device=dev)
    per_class = torch.where((t >= 1) & (t <= n_classes[:, None]),
                            (-(-max_sizes // chunk)).clamp(min=1), 0)

    parts = [n_classes.reshape(-1).long(), needed.reshape(-1).long()]
    if needed_rounds is not None:
        parts.append(needed_rounds.reshape(-1).long())
    with tracing.span("read.schedule"):
        host = torch.cat(parts).cpu().numpy()          # the one read
    k = mc + 1
    rounds = None
    if needed_rounds is not None:
        rounds = host[L + L * k:].reshape(L, k, n_rounds).astype(bool)
    i32 = lambda a: a.to(torch.int32)
    return _Schedule(n_classes=host[:L].tolist(),
                     needed=host[L:L + L * k].reshape(L, k).astype(bool),
                     needed_rounds=rounds, sorted_pad=i32(sorted_pad),
                     start_local=i32(start_local),
                     local_sizes=i32(local_sizes),
                     class_chunks=i32(per_class))


def recolor_steps(arrs, sched: _Schedule, exchange, cfg: RecolorConfig,
                  lanes_on=None, comm=None):
    """The chunked step loop of one iteration over a host-known schedule,
    for the L lanes of ``sched`` (``lanes_on``: host bools, ``None`` =
    all; a lane that is off takes no exchange and gets no stats — its
    chunk counts should be 0, so it colors nothing).  A ``FlatExchange``
    pushes after each run (``FlatExchange.push``); any other exchange
    object pulls at each event, as its ``__call__`` does.

    Returns ``(new_view, stats)``: ``n_colors`` as an ``(L,)`` device
    tensor, and per lane (python-int lists) ``n_colors_before``/``n_steps``
    (the class count), ``n_exchanges`` and ``wire_bytes``.
    """
    L = len(sched.n_classes)
    LP, n_slots = arrs["prio"].shape
    if comm is None:
        comm = AxisComm(LP // L, L)
    n_local_max = arrs["indptr"].shape[1] - 1
    mc = cfg.max_colors
    dev = sched.sorted_pad.device
    kw = dict(chunk=min(cfg.chunk, n_local_max), max_colors=mc,
              backend=cfg.backend)
    new_view = torch.zeros((LP, n_slots), dtype=torch.int32, device=dev)
    n_ex, n_bytes = [0] * L, [0] * L
    events: dict[int, list] = {}
    for lane in range(L):
        if lanes_on is None or lanes_on[lane]:
            for t in sched.events(lane):
                events.setdefault(t, [False] * L)[lane] = True
    sched_args = (sched.sorted_pad, sched.start_local, sched.local_sizes,
                  sched.class_chunks)
    push = isinstance(exchange, FlatExchange)
    running = [lane for lane in range(L) if lanes_on is None or lanes_on[lane]]
    lane_on = None
    if push and lanes_on is not None:
        lane_on = torch.tensor(lanes_on, dtype=torch.int32, device=dev)
    first = 1
    for t, due in sorted(events.items()):
        # classes first … t in one run: no exchange falls between them
        with tracing.span("recolor.run"):
            if cfg.distance == 2:
                new_view = ops.recolor_run_d2(
                    new_view, arrs["nbr"], arrs["nbr2"], *sched_args,
                    first_class=first, last_class=t, **kw)
            else:
                new_view = ops.recolor_run(
                    new_view, arrs["nbr"], *sched_args, first_class=first,
                    last_class=t, **kw)
        rounds = None
        if sched.needed_rounds is not None:
            rounds = [None if t == sched.n_classes[lane]
                      else sched.needed_rounds[lane, t] for lane in range(L)]
        if push:
            new_view, b = exchange.push(
                new_view, sched_args[:3], first, t, lane_on, lanes=due,
                rounds=rounds, backend=cfg.backend)
        else:
            new_view, b = exchange(new_view, lanes=due, rounds=rounds)
        first = t + 1
        for lane in range(L):
            if due[lane]:
                n_ex[lane] += 1
                n_bytes[lane] += b[lane]
    if push and events:
        # every valid row of a running lane ran once, so its pushes wrote
        # each of its entries once (device scalars, read with the counters)
        lane_entries = exchange.fan_out()[2]
        for lane in running:
            tracing.count("exchange.entries", lane_entries[lane])

    valid_local = (torch.arange(n_local_max, device=dev)
                   < arrs["n_local"][:, None])
    local = torch.where(valid_local, new_view[:, :n_local_max], 0)
    stats = dict(
        n_colors=comm.pmax(local.amax(dim=1)),
        n_colors_before=list(sched.n_classes),
        n_exchanges=n_ex,
        n_steps=list(sched.n_classes),
        wire_bytes=n_bytes,
    )
    return new_view, stats


def recolor_shards(arrs: dict, view: torch.Tensor, perm_kind: str,
                   cfg: RecolorConfig, key=None, comm=None):
    """One synchronous recoloring iteration of all P shards (the
    reference's ``recolor_spmd`` under ``run_sim``).

    ``view`` is a valid ``(P, n_slots)`` coloring with fresh ghosts.
    Returns the new view and python-int stats ``n_colors``,
    ``n_colors_distinct``, ``n_colors_before``, ``n_exchanges``,
    ``n_steps``, ``wire_bytes``, ``n_out_of_range``.  ``comm``: on a mesh,
    this rank's ``MeshComm`` (``view`` and ``arrs`` its one row).
    """
    if cfg.scheme == AUTO:
        raise ValueError("scheme='auto' must be resolved by an entry point "
                         "(resolve_cfg) before the run")
    n_local_max = arrs["indptr"].shape[1] - 1
    sizes, n_oor = class_sizes(view, arrs["n_local"], n_local_max,
                               cfg.max_colors, lanes=1, comm=comm)
    n_classes = (sizes > 0).sum(dim=1)
    rank = permutation_rank(sizes, perm_kind,
                            None if key is None else key.reshape(1, 2))
    exchange = make_exchange(arrs, cfg.comm_config, comm=comm)
    sched = recolor_schedule(arrs, view, rank, n_classes, cfg,
                             sparse_rounds(arrs), comm)
    new_view, st = recolor_steps(arrs, sched, exchange, cfg, comm=comm)
    sizes_after, _ = class_sizes(new_view, arrs["n_local"], n_local_max,
                                 cfg.max_colors, lanes=1, comm=comm)
    dev = torch.stack([st["n_colors"][0].long(), (sizes_after > 0).sum(),
                       n_oor[0].long()]).tolist()
    stats = {k: v[0] for k, v in st.items() if k != "n_colors"}
    stats.update(n_colors=dev[0], n_colors_distinct=dev[1],
                 n_out_of_range=dev[2])
    return new_view, stats


def recolor_sim(pg: PartitionedGraph, view, perm_kind: str,
                cfg: RecolorConfig, key=None, *, device=None):
    """One synchronous RC iteration of ``pg`` on one device.

    ``view`` — ``(P, n_slots)`` valid coloring with fresh ghosts (a tensor,
    or numpy via ``view_from_numpy``); ``perm_kind`` — one of
    ``RV``/``NI``/``ND``/``RAND``; ``key`` defaults to a per-call fold of
    ``cfg.seed`` (pass one for a reproducible RAND permutation).
    Returns ``(view, stats)`` as ``recolor_shards``.
    """
    device = resolve_device(device)
    cfg = resolve_cfg(pg, cfg)
    arrs = to_device(pg, device, sparse=cfg.scheme == SPARSE)
    if key is None:
        key = _default_key(cfg.seed)
    return recolor_shards(arrs, torch.as_tensor(view, device=device),
                          perm_kind, cfg, key)


def recolor_sharded(pg: PartitionedGraph, view, perm_kind: str,
                    cfg: RecolorConfig, mesh, key=None):
    """``recolor_sim`` on a mesh (``DeviceMesh``, one shard per rank of the
    shard axis): every rank passes the same global ``(P, n_slots)`` view
    and gets the same ``(view, stats)``, bitwise ``recolor_sim``'s for the
    same key."""
    cfg = resolve_cfg(pg, cfg)
    if key is None:
        key = _default_key(cfg.seed)

    def program(arrs, view, key, comm):
        new_view, stats = recolor_shards(arrs, view, perm_kind, cfg, key,
                                         comm=comm)
        return (new_view,), [stats]

    if not isinstance(view, torch.Tensor):
        view = torch.from_numpy(np.array(view, dtype=np.int32))
    (new_view,), stats = run_sharded(
        program, mesh, (pg.arrays(sparse=cfg.scheme == SPARSE), view),
        (key,))
    return new_view, stats[0]


def schedule_for_iteration(it: int, base: str = ND, rand_every: int = 0,
                           rand_pow2: bool = False) -> str:
    """Permutation for iteration `it` (1-based): ND-RAND%x / ND-RAND%2^i."""
    if rand_pow2:
        return RAND if it & (it - 1) == 0 and it > 1 else base
    if rand_every and it % rand_every == 0:
        return RAND
    return base


def recolor_iterations(pg: PartitionedGraph, view, n_iters: int,
                       cfg: RecolorConfig, *, base_perm: str = ND,
                       rand_every: int = 0, rand_pow2: bool = False,
                       seed: int = 0, collect=None, fused: bool = True,
                       device=None):
    """``n_iters`` RC iterations under an ND-RAND%x style schedule.

    By default through the recolor-only loop
    (``pipeline.recolor_loop_sim``); ``fused=False`` runs one
    ``recolor_sim`` per iteration, with key ``fold_in(key(seed), it)`` (the
    same stream), and ``collect=`` implies it: ``collect(view, stats)`` is
    called after every iteration.  Returns ``(view, history)``, one stats
    dict per iteration (with ``iteration`` and ``perm``).
    """
    if fused and collect is None and n_iters > 0:
        from .pipeline import PipelineConfig, recolor_loop_sim
        pcfg = PipelineConfig(
            color=None, recolor=cfg, n_iters=n_iters, base_perm=base_perm,
            rand_every=rand_every, rand_pow2=rand_pow2, seed=seed)
        view, history, _ = recolor_loop_sim(pg, view, pcfg, device=device)
        return view, history
    history = []
    for it in range(1, n_iters + 1):
        kind = schedule_for_iteration(it, base_perm, rand_every, rand_pow2)
        key = rng.fold_in(rng.key(seed), it)
        view, stats = recolor_sim(pg, view, kind, cfg, key, device=device)
        stats["iteration"], stats["perm"] = it, kind
        history.append(stats)
        if collect is not None:
            collect(view, stats)
    return view, history


def arc_order(view, n_local, n_local_max: int, rank) -> torch.Tensor:
    """aRC visit order ``(P, n_local_max)`` int32: each shard's local slots
    sorted by (class step, slot); -1 past the shard's vertices."""
    mc = rank.shape[0]
    step = rank[view[:, :n_local_max].long().clamp(0, mc - 1)]
    valid = (torch.arange(n_local_max, device=view.device)
             < n_local[:, None])
    key_v = torch.where(valid, step, INT32_MAX)
    slots = torch.argsort(key_v, dim=1, stable=True)   # stable: slot order
    return torch.where(key_v.gather(1, slots) < INT32_MAX, slots,
                       -1).to(torch.int32)


def arc_shards(arrs: dict, view: torch.Tensor, key, perm_kind: str,
               rc_cfg: RecolorConfig, sp_cfg: ColorConfig):
    """One asynchronous recoloring iteration of all P shards (the
    reference's ``arc_spmd`` under ``run_sim``): the class rank of
    ``view`` under ``perm_kind``, each shard's local order by class step,
    then the speculative coloring ``sp_cfg`` from an empty view.  The key
    splits into the rank's and the repair's streams.  Returns ``(view,
    stats)``: ``color_shards``' stats and ``n_out_of_range``."""
    n_local_max = arrs["indptr"].shape[1] - 1
    sizes, n_oor = class_sizes(view, arrs["n_local"], n_local_max,
                               rc_cfg.max_colors)
    k_rank, k_repair = rng.split(key)
    rank = permutation_rank(sizes, perm_kind, k_rank)
    order = arc_order(view, arrs["n_local"], n_local_max, rank)
    new_view, stats = color_shards(arrs, order, k_repair, sp_cfg)
    stats["n_out_of_range"] = int(n_oor)
    return new_view, stats


def arc_sim(pg: PartitionedGraph, view, perm_kind: str,
            rc_cfg: RecolorConfig, sp_cfg: ColorConfig, key=None, *,
            device=None):
    """One aRC iteration of ``pg`` on one device: order by local class rank
    (``rc_cfg``, ``perm_kind``) and rerun the speculative coloring
    (``sp_cfg``; its sequential mode too).  ``key`` defaults to a per-call
    fold of ``rc_cfg.seed``.  Returns ``(view, stats)`` as
    ``arc_shards``."""
    device = resolve_device(device)
    rc_cfg, sp_cfg = resolve_cfg(pg, rc_cfg), resolve_cfg(pg, sp_cfg)
    arrs = to_device(pg, device, sparse=sp_cfg.scheme == SPARSE)
    if key is None:
        key = _default_key(rc_cfg.seed)
    return arc_shards(arrs, torch.as_tensor(view, device=device), key,
                      perm_kind, rc_cfg, sp_cfg)
