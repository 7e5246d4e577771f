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

from repro_torch import rng
from repro_torch.kernels import ops

from .comm import (AUTO, DEFAULT_SCHEME, SCHEME_CHOICES, SPARSE, AxisComm,
                   CommConfig, make_exchange, resolve_scheme, stats_to_host,
                   take_rows)
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
                               distance: int = 1):
    """Uncolor the lower-priority endpoint of every same-color frontier edge.

    Only the ``n_need`` vertices colored this round (the first ``n_steps``
    superstep chunks of the visit order) are rescanned, all against the
    pre-detection ``view``, in one ``ops.detect_conflicts_frontier[_d2]``
    call (one kernel launch on the card).  ``distance=2`` also scans the
    two-hop ELL rows (both endpoints of a distance-2 conflict list each
    other in ``nbr2``).  Returns (new_view, n_conflicts,
    any_boundary_conflict) — the last two as device scalars.
    """
    kw = dict(n_steps=n_steps, superstep=superstep, backend=backend)
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


def _speculate(arrs: dict, order: torch.Tensor, key: torch.Tensor,
               cfg: ColorConfig, exchange):
    """The speculate/repair round loop; returns (view, n_rounds,
    n_exchanges, wire_bytes)."""
    P, n_slots = arrs["prio"].shape
    n_local_max = arrs["indptr"].shape[1] - 1
    dev = order.device
    comm = AxisComm(P)
    # the superstep clamps to the shard's row count: bitwise-identical, and
    # small graphs stop gathering pure padding
    S = min(cfg.superstep, n_local_max)
    n_chunks_max = -(-n_local_max // S)
    view = torch.zeros((P, n_slots), dtype=torch.int32, device=dev)
    # colors handed out per shard, never decremented (the sequential mode)
    usage = (None if cfg.use_parallel_chunk else
             torch.zeros((P, cfg.max_colors), dtype=torch.int32, device=dev))
    offset = None
    if cfg.selection == ops.STAGGERED:
        offset = cfg.stagger_offset(comm.index(dev)).to(torch.int32)[:, None]
    shard_ids = comm.index(dev)
    pos = torch.arange(n_chunks_max * S, device=dev)

    rnd = n_rounds = n_ex = n_bytes = 0
    n_conf = torch.ones((), dtype=torch.int64, device=dev)   # round 0 runs
    do_final = torch.zeros((), dtype=torch.int64, device=dev)
    while True:
        order_r, n_need = _compact_order(order, view)
        order_pad = torch.cat(
            [order_r, torch.full((P, S), -1, dtype=order_r.dtype, device=dev)],
            dim=1)
        # which superstep chunks color a boundary vertex on any shard: the
        # exchanges the others would trigger are elided (ghosts cannot move)
        opad = order_pad[:, :n_chunks_max * S]
        bnd = ((opad >= 0) & (pos < n_need[:, None])
               & ~take_rows(arrs["is_internal"], opad.clamp(min=0)))
        chunk_bnd = comm.pmax(bnd.reshape(P, n_chunks_max, S).any(dim=2))
        # the round's one device->host read
        head = torch.stack([n_conf, do_final.long(), comm.pmax(n_need).long()])
        host = torch.cat([head, chunk_bnd.long()]).tolist()
        conf_prev, final_prev, n_need_max = host[:3]
        chunk_bnd_h = host[3:]
        if final_prev:     # publish the previous round's uncolorings
            view, b = exchange(view)
            n_ex, n_bytes = n_ex + 1, n_bytes + b
        if not (conf_prev > 0 and rnd < cfg.max_rounds):
            break
        n_rounds += 1
        n_steps = -(-n_need_max // S)
        rkeys = rng.fold_in(rng.fold_in(key, rnd), shard_ids)
        rand = rng.as_int32_bits(rng.bits(rkeys, n_local_max))
        pending, first = False, 0
        for si in range(n_steps):
            pending = pending or bool(chunk_bnd_h[si])
            due = (si + 1) % cfg.exchange_every == 0 or si == n_steps - 1
            if (due and pending) or si == n_steps - 1:
                view = _color_supersteps(view, usage, order_pad, rand,
                                         arrs, offset, cfg, S, first,
                                         si + 1 - first)
                first = si + 1
            if due and pending:
                view, b = exchange(view)
                n_ex, n_bytes, pending = n_ex + 1, n_bytes + b, False
        view, n_conf, do_final = _detect_conflicts_frontier(
            view, arrs, order_pad, n_steps, n_need, S, backend=cfg.backend,
            distance=cfg.distance)
        rnd += 1
    return view, n_rounds, n_ex, n_bytes


def color_shards(arrs: dict, order: torch.Tensor, key: torch.Tensor,
                 cfg: ColorConfig):
    """Speculative coloring of all P shards (the reference's ``color_spmd``
    under ``run_sim``).

    ``arrs`` is the device dict (``graph.to_device``); ``order`` the ``(P,
    n_local_max)`` visit order of local slots, -1 = skip; ``key`` an
    ``rng`` key.  Returns ``(view, stats)``: the ``(P, n_slots)`` int32
    view and python-int stats ``n_colors`` (max id), ``n_colors_distinct``,
    ``n_rounds``, ``n_exchanges``, ``wire_bytes`` (per shard).
    """
    if cfg.scheme == AUTO:
        raise ValueError("scheme='auto' must be resolved by an entry point "
                         "(resolve_cfg) before the run")
    require_halo(arrs, cfg.distance)
    view, n_rounds, n_ex, n_bytes = _speculate(
        arrs, order, key, cfg, make_exchange(arrs, cfg.comm_config))
    # distinct classes in use — the quality metric (the max id alone can
    # overstate the color count)
    n_local_max = arrs["indptr"].shape[1] - 1
    local = view[:, :n_local_max]
    valid = (torch.arange(n_local_max, device=view.device)
             < arrs["n_local"][:, None])
    in_use = torch.bincount(local[valid].long(), minlength=cfg.max_colors)
    stats = dict(
        n_colors=local.max(),
        n_colors_distinct=(in_use[1:] > 0).sum(),
        n_rounds=n_rounds,
        n_exchanges=n_ex,
        wire_bytes=n_bytes,
    )
    return view, stats_to_host(stats)


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
