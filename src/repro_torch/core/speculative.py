"""Speculative greedy distributed coloring (Bozdağ et al. framework, §2.2).

The reference's ``repro.core.speculative`` over ``(P, …)`` tensors of
one device:

  while conflicts remain:
    compact uncolored vertices to the front of the visit order
    for each superstep chunk of `superstep` vertices:
        color it as tile-parallel sub-tiles against the (stale) view, or
        (sequential mode) one vertex at a time
        exchange boundary colors (every `exchange_every` supersteps),
        skipped when no shard colored a boundary vertex since the last one
    detect conflicts over the round's frontier
    (``ops.detect_conflicts_frontier``, one call per round); the
    lower-priority endpoint is uncolored and retried next round

The reference's ``lax`` loops become Python loops.  Their trip counts and
exchange decisions are shard-uniform, so each round reads the device once:
the frontier size, the per-chunk boundary flags, and the previous round's
conflict count and final-exchange flag travel together.  Every superstep
up to the next boundary exchange is one call of ``ops.select_run``, which
colors its tiles in order (one kernel launch on the card).

A batch of L same-shape graphs (lanes, ``color_lanes``; ``color_many``'s
buckets) runs as one ``(L·P, …)`` batch of shards, as the reference runs
``color_spmd`` under a second ``vmap``: the rounds go in lockstep (one
round index for all lanes), and each lane keeps its own control flow — a
lane takes part in a round while its previous round found conflicts, and
has its own frontier, superstep count, boundary flags, exchange points and
final exchange, all read in the round's one device read.  The launches of
a round split at the union of the lanes' run boundaries: a run cut at
another lane's exchange point colors the same, since the kernels color in
order, and positions past a lane's own frontier hold colored vertices, so
they color nothing.  A lane stops with an empty frontier (every vertex of
its order colored) or at the round cap, which all lanes share, so a
stopped lane is never colored again.  Exchanges refresh only the due
lanes' ghosts (``comm.FlatExchange``).

Sequential mode (``parallel_chunk=False``, the paper's scalar loop, and
every Least-Used run): the same rounds, runs and exchanges, but each run
is one call of ``ops.greedy_run``, which colors one vertex at a time per
shard, each seeing every color written before it; a ``(P, max_colors)``
usage histogram (read by Least-Used) carries across supersteps and
rounds and, as in the reference, still counts repaired vertices.

Distance 2 (``ColorConfig(distance=2)`` on a ``halo=2`` partition): the
selection ORs the one-hop and the strict two-hop colors
(``ops.select_run_d2``) and the repair scans both ELL rows
(``ops.detect_conflicts_frontier_d2``); the round structure is unchanged.
``partial=True`` with ``marked=`` colors only a marked subset (bipartite
partial D2 coloring): unmarked vertices leave the visit order, stay at
color 0 and are invisible to every bitset.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import rng, tracing
from repro_torch.kernels import ops
from repro_torch.kernels.ref import take_rows

from .comm import (AUTO, DEFAULT_SCHEME, SCHEME_CHOICES, SPARSE, AxisComm,
                   CommConfig, make_exchange, resolve_scheme, run_sharded)
from .graph import PartitionedGraph, to_device


def validate_color_bounds(max_colors: int, wire16: bool, backend: str):
    """Shared config checks of ColorConfig / RecolorConfig."""
    if max_colors % 32 or max_colors <= 0:
        raise ValueError("max_colors must be a positive multiple of 32")
    if wire16 and max_colors > 32767:
        raise ValueError(f"wire16 carries colors as int16; max_colors="
                         f"{max_colors} exceeds 32767")
    if backend not in ops.BACKENDS:
        raise ValueError(f"bad backend {backend!r}, want one of "
                         f"{ops.BACKENDS}")


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU.  Raises when CUDA is asked for (the default) but missing."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU")
    return device


@dataclasses.dataclass(frozen=True)
class ColorConfig:
    """Static configuration of one distributed coloring run.

    ``superstep`` and ``tile`` are vertex counts per chunk (clamped to the
    shard's row count); ``max_colors`` is the 32-aligned color-id bound;
    ``exchange_every`` counts supersteps between boundary exchanges;
    ``max_rounds`` bounds the speculate/repair rounds; ``distance`` is 1
    (proper coloring) or 2 (needs a ``halo=2`` partition); ``partial``
    colors only the ``marked=`` subset; ``parallel_chunk=False`` (and any
    ``least_used`` run) colors each superstep sequentially.
    """

    max_colors: int = 1024
    superstep: int = 512           # paper's superstep size (vertices per chunk)
    selection: str = ops.FIRST_FIT
    random_x: int = 10             # X for Random-X Fit
    stagger_estimate: int = 64     # initial color estimate for Staggered FF
    exchange_every: int = 1        # 1 = synchronous; k>1 = bounded staleness
    max_rounds: int = 64
    scheme: str = DEFAULT_SCHEME   # "sparse" | "allgather" | "auto"
    wire16: bool = False           # int16 boundary payloads
    parallel_chunk: bool = True    # tile-parallel supersteps
    tile: int = 128                # vertices colored at once within a superstep
    backend: str = "auto"          # kernels.ops backend: auto | torch | cuda
    distance: int = 1
    partial: bool = False
    seed: int = 0

    def __post_init__(self):
        validate_color_bounds(self.max_colors, self.wire16, self.backend)
        if self.scheme not in SCHEME_CHOICES:
            raise ValueError(f"bad scheme {self.scheme!r}")
        if self.tile <= 0 or self.superstep <= 0 or self.exchange_every <= 0:
            raise ValueError("tile, superstep and exchange_every must be > 0")
        if self.selection not in ops.STRATEGIES:
            raise ValueError(f"unknown selection {self.selection!r}")
        if self.distance not in (1, 2):
            raise ValueError(f"bad distance {self.distance}, want 1 or 2")

    @property
    def comm_config(self) -> CommConfig:
        return CommConfig(scheme=self.scheme, wire16=self.wire16)

    @property
    def use_parallel_chunk(self) -> bool:
        """Least-Used chases a running histogram, so it stays sequential."""
        return self.parallel_chunk and self.selection != ops.LEAST_USED

    def stagger_offset(self, p_idx):
        """Staggered First Fit start color of processor ``p_idx``."""
        return (p_idx * self.stagger_estimate) % self.max_colors


def _color_supersteps(view, usage, order_pad, rand, arrs, offset,
                      cfg: ColorConfig, superstep: int, first: int,
                      count: int):
    """Color supersteps ``first … first + count - 1`` against the view,
    with no exchange between them, in one ``ops`` call.

    Tile-parallel (``ops.select_run[_d2]``): each superstep colors as
    sub-tiles of ``cfg.tile`` vertices per shard, the view updating between
    sub-tiles; same-tile neighbours may conflict — the round loop repairs
    them.  Sequential (``ops.greedy_run[_d2]``): one vertex at a time,
    counting each color in ``usage``.  Updates ``view`` (and ``usage``) in
    place and returns the view.
    """
    kw = dict(first_step=first, n_steps=count, superstep=superstep,
              max_colors=cfg.max_colors, selection=cfg.selection,
              x=cfg.random_x, backend=cfg.backend)
    nbrs = (arrs["nbr"], arrs["nbr2"]) if cfg.distance == 2 else (
        arrs["nbr"],)
    if not cfg.use_parallel_chunk:
        run = ops.greedy_run_d2 if cfg.distance == 2 else ops.greedy_run
        return run(view, usage, order_pad, *nbrs, rand, offset, **kw)[0]
    run = ops.select_run_d2 if cfg.distance == 2 else ops.select_run
    return run(view, order_pad, *nbrs, rand, offset,
               tile=min(cfg.tile, superstep), **kw)


def _detect_conflicts_frontier(view, arrs, order_pad, n_steps: int, n_need,
                               superstep: int, backend: str = "auto",
                               distance: int = 1, lanes: int = 1):
    """Uncolor the lower-priority endpoint of every same-color frontier edge.

    Only the ``n_need`` vertices colored this round (the first ``n_steps``
    superstep chunks of the visit order) are rescanned, all against the
    pre-detection ``view``, in one ``ops.detect_conflicts_frontier[_d2]``
    call (one kernel launch on the card).  ``distance=2`` also scans the
    two-hop ELL rows (both endpoints of a distance-2 conflict list each
    other in ``nbr2``).  Returns (new_view, n_conflicts,
    any_boundary_conflict) — the last two as ``(lanes,)`` device tensors.
    """
    kw = dict(n_steps=n_steps, superstep=superstep, lanes=lanes,
              backend=backend)
    common = (view, arrs["prio"], arrs["is_internal"], order_pad)
    if distance == 2:
        return ops.detect_conflicts_frontier_d2(
            *common, arrs["nbr"], arrs["nbr2"], n_need, **kw)
    return ops.detect_conflicts_frontier(*common, arrs["nbr"], n_need, **kw)


def _compact_order(order, view):
    """Stable-move still-uncolored vertices to the front of each shard's
    visit order; returns (order, per-shard count)."""
    v_safe = order.clamp(min=0)
    needs = (order >= 0) & (take_rows(view, v_safe) == 0)
    perm = torch.argsort((~needs).to(torch.uint8), dim=1, stable=True)
    return order.gather(1, perm), needs.sum(dim=1)


def _round_plan(n_steps: list, chunk_bnd: list, exchange_every: int):
    """One round's launches and exchanges for every lane.

    ``n_steps[l]`` is lane l's superstep count (0 when it sits the round
    out) and ``chunk_bnd[l]`` its per-chunk boundary flags.  Lane l
    exchanges after superstep si when it is due (every
    ``exchange_every``-th, and its last) and a boundary vertex was colored
    since its last exchange.  Returns ``[(si, due lanes)]``: each entry
    ends a launch after superstep si — the union of every lane's exchange
    points and last supersteps — and exchanges the lanes marked due.
    """
    points: dict[int, list] = {}
    L = len(n_steps)
    for lane, (n, flags) in enumerate(zip(n_steps, chunk_bnd)):
        pending = False
        for si in range(n):
            pending = pending or bool(flags[si])
            due = (si + 1) % exchange_every == 0 or si == n - 1
            if (due and pending) or si == n - 1:
                points.setdefault(si, [False] * L)
            if due and pending:
                points[si][lane] = True
                pending = False
    return sorted(points.items())


def _speculate(arrs: dict, order: torch.Tensor, keys: torch.Tensor,
               cfg: ColorConfig, exchange, comm):
    """The speculate/repair round loop of ``comm.L`` lanes; returns (view,
    and per lane: n_rounds, n_exchanges, wire_bytes).

    On a mesh every value the host reads is reduced over the shard group
    first, so the shards of a lane take the same rounds, launches and
    exchanges; a rank whose lanes are all done keeps calling
    ``lane_uniform`` until the batch rows of a 2D mesh are done too."""
    L, rows = comm.L, comm.rows
    n_slots = arrs["prio"].shape[1]
    n_local_max = arrs["indptr"].shape[1] - 1
    dev = order.device
    # the superstep clamps to the shard's row count: bitwise-identical, and
    # small graphs stop gathering pure padding
    S = min(cfg.superstep, n_local_max)
    n_chunks_max = -(-n_local_max // S)
    view = torch.zeros((rows, n_slots), dtype=torch.int32, device=dev)
    # colors handed out per shard, never decremented (the sequential mode)
    usage = (None if cfg.use_parallel_chunk else torch.zeros(
        (rows, cfg.max_colors), dtype=torch.int32, device=dev))
    shard_ids = comm.index(dev)
    offset = None
    if cfg.selection == ops.STAGGERED:
        offset = cfg.stagger_offset(shard_ids).to(torch.int32)[:, None]
    pos = torch.arange(n_chunks_max * S, device=dev)
    # every round's Random-X key of every shard, fold_in(fold_in(key, rnd),
    # shard), derived at once: (L·P, max_rounds, 2)
    round_keys = rng.fold_in(
        rng.fold_in(keys[:, None, :],
                    torch.arange(cfg.max_rounds, device=dev))[:, None],
        shard_ids.view(L, comm.shards, 1)).reshape(rows, cfg.max_rounds, 2)

    rnd = 0
    n_rounds, n_ex, n_bytes = [0] * L, [0] * L, [0] * L
    n_conf = torch.ones(L, dtype=torch.int64, device=dev)   # round 0 runs
    # boundary losers of the last repair per lane: their uncoloring is
    # exchanged before the next round
    do_final = torch.zeros(L, dtype=torch.int64, device=dev)

    def run_exchange(due):
        nonlocal view
        view, b = exchange(view, lanes=due)
        for lane in range(L):
            if due[lane]:
                n_ex[lane] += 1
                n_bytes[lane] += b[lane]

    while True:
        with tracing.span("color.frontier"):
            order_r, n_need = _compact_order(order, view)
            order_pad = torch.cat(
                [order_r, torch.full((rows, S), -1, dtype=order_r.dtype,
                                     device=dev)], dim=1)
            # which superstep chunks color a boundary vertex on any shard
            # of the lane: the exchanges the others would trigger are
            # elided (ghosts cannot move)
            opad = order_pad[:, :n_chunks_max * S]
            bnd = ((opad >= 0) & (pos < n_need[:, None])
                   & ~take_rows(arrs["is_internal"], opad.clamp(min=0)))
            lane_max = comm.pmax(torch.cat(
                [n_need[:, None],
                 bnd.reshape(rows, n_chunks_max, S).any(dim=2).long()],
                dim=1))
            # the round's one device->host read, one row per lane
            with tracing.span("read.round"):
                host = torch.cat([torch.stack([n_conf, do_final], dim=1),
                                  lane_max], dim=1).tolist()
            if rnd:           # the last repair's losers (round 0 has none)
                tracing.count("color.losers", sum(h[0] for h in host))
            final = [bool(h[1]) for h in host]
            if any(final):     # publish the previous round's uncolorings
                run_exchange(final)
            active = [h[0] > 0 and rnd < cfg.max_rounds for h in host]
            if not comm.lane_uniform(any(active)):
                break
            if not any(active):   # a lane of another batch row still runs
                comm.wait_lanes()
                break
        with tracing.span("color.round"):
            steps = [-(-h[2] // S) if on else 0
                     for h, on in zip(host, active)]
            for lane in range(L):
                n_rounds[lane] += active[lane]
            rand = rng.as_int32_bits(rng.bits(round_keys[:, rnd],
                                              n_local_max))
            first = 0
            for si, due in _round_plan(steps, [h[3:] for h in host],
                                       cfg.exchange_every):
                with tracing.span("color.run"):
                    view = _color_supersteps(view, usage, order_pad, rand,
                                             arrs, offset, cfg, S, first,
                                             si + 1 - first)
                first = si + 1
                if any(due):
                    run_exchange(due)
            with tracing.span("color.repair"):
                view, n_conf, bnd_conf = _detect_conflicts_frontier(
                    view, arrs, order_pad, max(steps), n_need, S,
                    backend=cfg.backend, distance=cfg.distance, lanes=L)
                counts = comm.lane_psum(
                    torch.stack([n_conf, bnd_conf.long()], dim=1))
            n_conf, do_final = counts[:, 0], counts[:, 1]
            rnd += 1
    return view, n_rounds, n_ex, n_bytes


def color_lanes(arrs: dict, order: torch.Tensor, keys: torch.Tensor,
                cfg: ColorConfig, lanes: int = 1, comm=None):
    """Speculative coloring of a batch of ``lanes`` same-shape graphs laid
    end to end on the shard axis (one lane: ``color_shards``).

    ``arrs`` is the ``(L·P, …)`` device dict (``graph.to_device`` or
    ``graph.bucket_to_device``); ``order`` the ``(L·P, n_local_max)``
    visit order of local slots, -1 = skip; ``keys`` ``(L, 2)`` ``rng``
    keys, one per lane; ``comm`` (optional) the lanes' ``AxisComm``, whose
    index maps it reuses, or on a mesh this rank's ``MeshComm``, with
    ``(L, …)`` rows: one shard of each lane.  Returns ``(view, stats)``:
    the ``(L·P, n_slots)`` int32 view and one dict of python-int stats per
    lane
    (``n_colors`` the max id, ``n_colors_distinct``, ``n_rounds``,
    ``n_exchanges``, ``wire_bytes`` per shard), each bitwise what the lane
    would give alone.
    """
    if cfg.scheme == AUTO:
        raise ValueError("scheme='auto' must be resolved by an entry point "
                         "(resolve_cfg) before the run")
    require_halo(arrs, cfg.distance)
    comm = lane_comm(arrs, lanes, comm)
    keys = keys.reshape(lanes, 2).to(order.device)
    view, n_rounds, n_ex, n_bytes = _speculate(
        arrs, order, keys, cfg,
        make_exchange(arrs, cfg.comm_config, lanes=lanes, comm=comm), comm)
    # distinct classes in use — the quality metric (the max id alone can
    # overstate the color count)
    n_local_max = arrs["indptr"].shape[1] - 1
    mc = cfg.max_colors
    local = view[:, :n_local_max]
    dev = view.device
    valid = torch.arange(n_local_max, device=dev) < arrs["n_local"][:, None]
    flat = comm.lane(dev)[:, None] * mc + local.long()
    in_use = torch.zeros(lanes * mc + 1, dtype=torch.bool, device=dev)
    in_use[torch.where(valid, flat, lanes * mc)] = True
    in_use = comm.lane_pmax(in_use[:-1].view(lanes, mc))
    with tracing.span("read.stats"):
        dev_stats = torch.stack([comm.pmax(local.amax(dim=1)).long(),
                                 in_use[:, 1:].sum(dim=1)], dim=1).tolist()
    return view, [dict(n_colors=nc, n_colors_distinct=nd,
                       n_rounds=n_rounds[lane], n_exchanges=n_ex[lane],
                       wire_bytes=n_bytes[lane])
                  for lane, (nc, nd) in enumerate(dev_stats)]


def lane_comm(arrs: dict, lanes: int, comm=None):
    """The ``AxisComm`` of ``lanes`` graphs laid end to end in ``arrs``
    (``comm`` itself when given, ``AxisComm`` or ``MeshComm``, after a
    shape check)."""
    LP = arrs["prio"].shape[0]
    if lanes <= 0 or LP % lanes:
        raise ValueError(f"{lanes} lanes do not divide the {LP} shards")
    if comm is None:
        return AxisComm(LP // lanes, lanes)
    if (comm.rows, comm.L) != (LP, lanes):
        raise ValueError(f"comm of {comm.L} lanes x {comm.shards} shards "
                         f"does not match {lanes} lanes of {LP} rows")
    return comm


def color_shards(arrs: dict, order: torch.Tensor, key: torch.Tensor,
                 cfg: ColorConfig):
    """Speculative coloring of all P shards (the reference's ``color_spmd``
    under ``run_sim``): ``color_lanes`` with one lane.

    ``arrs`` is the device dict (``graph.to_device``); ``order`` the ``(P,
    n_local_max)`` visit order of local slots, -1 = skip; ``key`` an
    ``rng`` key.  Returns ``(view, stats)``: the ``(P, n_slots)`` int32
    view and python-int stats ``n_colors`` (max id), ``n_colors_distinct``,
    ``n_rounds``, ``n_exchanges``, ``wire_bytes`` (per shard).
    """
    view, stats = color_lanes(arrs, order, key, cfg)
    return view, stats[0]


def require_halo(arrs: dict, distance: int) -> None:
    """Distance 2 reads the two-hop ELL: raise unless ``arrs`` has it."""
    if distance == 2 and "nbr2" not in arrs:
        raise ValueError("distance=2 needs the two-hop halo: partition with "
                         "partition_graph(g, P, halo=2)")


def apply_partial(order, cfg: ColorConfig, marked):
    """Mask the visit order down to the marked subset (``cfg.partial``).

    ``marked`` is a host-side ``(P, n_local_max)`` bool mask of local
    slots; unmarked vertices become ``-1`` entries (skipped everywhere),
    stay at color 0 and — color 0 being invisible to the forbidden
    bitsets — act exactly like the uncolored through-vertices of
    partial/bipartite D2 coloring.  Runs on the host, before the order
    moves to the device.
    """
    if not cfg.partial:
        if marked is not None:
            raise ValueError("marked= requires partial=True on the config")
        return order
    if marked is None:
        raise ValueError("partial=True needs a marked= (P, n_local_max) mask")
    if isinstance(order, torch.Tensor):
        order = order.cpu()
    order = np.asarray(order)
    marked = np.asarray(marked, dtype=bool)
    keep = np.take_along_axis(marked, np.maximum(order, 0), axis=1)
    return np.where((order >= 0) & keep, order, -1)


def resolve_cfg(pg: PartitionedGraph, cfg):
    """Concretize ``scheme="auto"`` against this partition's comm plan
    (any frozen config with a ``scheme`` field)."""
    if cfg.scheme == AUTO:
        cfg = dataclasses.replace(cfg, scheme=resolve_scheme(AUTO, pg))
    return cfg


def color_graph_sim(pg: PartitionedGraph, order, cfg: ColorConfig, key=None,
                    *, marked=None, device=None):
    """Distributed coloring of ``pg``, all P shards on one device.

    ``order`` — ``(P, n_local_max)`` int32 visit order (``compute_order``);
    ``key`` — ``rng`` key (default ``rng.key(cfg.seed)``); ``marked`` —
    ``(P, n_local_max)`` bool host mask, only with ``cfg.partial``;
    ``device`` — default CUDA, ``"cpu"`` runs the plain kernels on the CPU.
    Returns ``(view, stats)`` as ``color_shards``.
    """
    device = resolve_device(device)
    cfg = resolve_cfg(pg, cfg)
    order = apply_partial(order, cfg, marked)
    arrs = to_device(pg, device, sparse=cfg.scheme == SPARSE)
    if key is None:
        key = rng.key(cfg.seed)
    return color_shards(arrs, torch.as_tensor(order, device=device), key, cfg)


def color_graph_sharded(pg: PartitionedGraph, order, cfg: ColorConfig, mesh,
                        key=None, *, marked=None):
    """``color_graph_sim`` on a mesh (a ``DeviceMesh`` over an initialised
    world, ``launch.mesh``): one shard of ``pg`` per rank of the shard
    axis, on the rank's device.  Every rank passes the same arguments and
    returns the same ``(view, stats)``: the ``(P, n_slots)`` view gathered
    in shard order, and the stats, bitwise those of ``color_graph_sim``."""
    cfg = resolve_cfg(pg, cfg)
    order = apply_partial(order, cfg, marked)
    if key is None:
        key = rng.key(cfg.seed)

    def program(arrs, order, key, comm):
        view, stats = color_lanes(arrs, order, key, cfg, comm=comm)
        return (view,), stats

    (view,), stats = run_sharded(
        program, mesh, (pg.arrays(sparse=cfg.scheme == SPARSE),
                        np.asarray(order)), (key,))
    return view, stats[0]
