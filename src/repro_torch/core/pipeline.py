"""The color→recolor pipeline: speculative coloring, then K recoloring
iterations with an adaptive stop, all shards on one device — for one graph
(``pipeline_sim``) or a batch of graphs (``color_many``).

The reference's fused ``repro.core.pipeline`` (one ``lax.while_loop``)
becomes a Python loop over device-resident state.  Each iteration reads
the device once (its chunk schedule, ``recolor.recolor_schedule``); that
read also carries the class count of the view the previous iteration
produced, which is exactly the previous iteration's distinct-color count,
so the ``patience`` stop is decided without a further read.  The
per-iteration stats (the ``HISTORY_STATS`` columns) cross to the host
once, at the end.

**Batched multi-graph pipeline** (``color_many``): ``bucket_graphs`` pads
the partitions into shape buckets, and a bucket of B graphs runs as one
batch of ``B·P`` shards (lanes laid end to end), so every kernel launch of
a step serves every lane and the host loop runs once for all of them.
Each lane keeps its own keys, control flow, exchanges, history and
adaptive stop (``speculative.color_lanes``, ``recolor_lanes``): a lane
whose stop tripped is frozen — it colors nothing, exchanges nothing,
keeps its view and gets no history row — while its peers go on, as the
reference's ``vmap`` of ``lax.while_loop`` select-masks a finished lane.
Each lane's result is bitwise a solo ``pipeline_sim`` of its padded member
with the same keys; ``pipeline_sim`` itself is the one-lane case of the
same loops.

**Stepped form** (the serving engines of ``launch.serve_coloring``): the
loop's state between iterations is a ``RecolorCarry`` (``pipeline_carry``
colors one graph into one; ``recolor_carry_init`` makes one from a view),
and ``pipeline_step`` advances every running lane by a chunk of
iterations, each lane at its own iteration (its own permutation kind and
key), reporting ``done`` per lane as the reference does, right after the
chunk.  ``recolor_lanes`` is the same loop run to the end in one call.
``engine_init/step/put_program`` are the engines' program-cache entries.
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict

import numpy as np
import torch

from repro_torch import rng, tracing

from . import ordering
from .comm import (ALLGATHER, AUTO, AXIS, SPARSE, AxisComm, MeshComm,
                   allgather_bytes_per_exchange, batch_axis_size,
                   make_exchange, mesh_axes, run_sharded, run_sharded_many)
from .graph import (GraphBucket, PartitionedGraph, _ceil_pow2,
                    bucket_graphs, bucket_to_device, to_device)
from .ordering import compute_order
from .recolor import (ALL_PERMS, INT32_MAX, ND, PERM_IDS, RAND,
                      RecolorConfig, class_sizes, permutation_rank,
                      recolor_schedule, recolor_steps,
                      schedule_for_iteration)
from .speculative import (ColorConfig, apply_partial, color_lanes, lane_comm,
                          resolve_cfg, resolve_device)

# Column layout of the per-iteration history (the reference's order).
# ``ran`` marks rows the adaptive stop reached.
HISTORY_STATS = ("n_colors", "n_colors_distinct", "n_colors_before",
                 "n_exchanges", "n_steps", "wire_bytes", "n_out_of_range",
                 "perm_id", "ran")


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Static configuration of the color→recolor pipeline.

    ``n_iters`` (K) caps the recoloring iterations; ``patience`` (in
    iterations, 0 = off) stops once the global distinct-color count has
    not improved for that many iterations.  One device layout serves both
    stages, so ``color`` and ``recolor`` must agree on ``distance``.
    """

    color: ColorConfig | None = None
    recolor: RecolorConfig = RecolorConfig()
    n_iters: int = 8               # K — max recoloring iterations
    base_perm: str = ND            # schedule base (paper's best: ND)
    rand_every: int = 0            # ND-RAND%x: RAND every x-th iteration
    rand_pow2: bool = False        # ND-RAND%2^i: RAND at power-of-two its
    patience: int = 0              # adaptive stop (0 = run all K)
    seed: int = 0                  # recoloring key seed (folded per it)

    def __post_init__(self):
        if self.n_iters < 0 or self.patience < 0:
            raise ValueError("n_iters and patience must be >= 0")
        if self.base_perm not in ALL_PERMS:
            raise ValueError(f"bad perm {self.base_perm!r}")
        if (self.color is not None
                and self.color.distance != self.recolor.distance):
            raise ValueError("one device layout serves both stages: color "
                             "and recolor must agree on distance")

    @property
    def kind_ids(self) -> tuple:
        """Per-iteration permutation ids (the ND-RAND%x schedule)."""
        return tuple(
            PERM_IDS[schedule_for_iteration(it, self.base_perm,
                                            self.rand_every, self.rand_pow2)]
            for it in range(1, self.n_iters + 1))

    @property
    def has_auto(self) -> bool:
        """True while any stage's scheme is still the unresolved "auto"."""
        return (self.recolor.scheme == AUTO
                or (self.color is not None and self.color.scheme == AUTO))

    @property
    def needs_sparse_plan(self) -> bool:
        return (self.recolor.scheme == SPARSE
                or (self.color is not None and self.color.scheme == SPARSE))


# ------------------------------------------------------------ the loops --

@dataclasses.dataclass
class RecolorCarry:
    """The recolor loop's state between iterations, for L lanes: the
    reference's carry ``(view, it, best, stall, hist, sizes,
    n_out_of_range)``.

    ``it`` is 1-based per lane (``it - 1`` iterations have run; a lane
    past its stop, or an empty engine lane at ``K + 1``, is frozen);
    ``best`` and ``stall`` are the adaptive stop's state.  They and the
    history ``hist`` ``(L, max(K, 1), len(HISTORY_STATS))`` (rows the
    stop never reached stay zero) live on the host; ``view`` ``(L·P,
    n_slots)``, the class ``sizes`` ``(L, max_colors)`` and the
    out-of-range counts ``n_oor`` ``(L,)`` on the device.
    """

    view: torch.Tensor
    it: list
    best: list
    stall: list
    hist: np.ndarray
    sizes: torch.Tensor
    n_oor: torch.Tensor

    @property
    def lanes(self) -> int:
        return len(self.it)

    def history(self, lane: int = 0) -> list:
        """Lane ``lane``'s history: one dict per iteration it ran (the
        reference's ``_history_to_host``)."""
        out = []
        for i, vals in enumerate(self.hist[lane].tolist()):
            row = dict(zip(HISTORY_STATS, vals))
            if not row.pop("ran"):
                break
            row["perm"] = ALL_PERMS[row.pop("perm_id")]
            row["iteration"] = i + 1
            out.append(row)
        return out


def recolor_carry_init(arrs: dict, view: torch.Tensor, cfg: PipelineConfig,
                       lanes: int = 1, comm=None) -> RecolorCarry:
    """The recolor loop's initial carry from the colored ``(L·P, n_slots)``
    view of ``lanes`` graphs (on a mesh: ``(L, n_slots)``, with the rank's
    ``MeshComm``): every lane at iteration 1 with an empty history.
    ``pipeline_step`` advances it; ``recolor_lanes`` runs it to the end."""
    n_local_max = arrs["indptr"].shape[1] - 1
    sizes, n_oor = class_sizes(view, arrs["n_local"], n_local_max,
                               cfg.recolor.max_colors, lanes=lanes, comm=comm)
    hist = np.zeros((lanes, max(cfg.n_iters, 1), len(HISTORY_STATS)),
                    np.int64)
    return RecolorCarry(view=view, it=[1] * lanes, best=[INT32_MAX] * lanes,
                        stall=[0] * lanes, hist=hist, sizes=sizes,
                        n_oor=n_oor)


def _patience(cfg: PipelineConfig) -> int:
    return cfg.patience if cfg.patience else cfg.n_iters + 1  # never trips


def _lane_on(carry: RecolorCarry, cfg: PipelineConfig) -> list:
    """Per lane: does its adaptive stop still hold (the reference's
    ``lane_on``)?"""
    return [it <= cfg.n_iters and stall < _patience(cfg)
            for it, stall in zip(carry.it, carry.stall)]


def _check_resolved(cfg: PipelineConfig) -> None:
    if cfg.recolor.scheme == AUTO:
        raise ValueError("scheme='auto' must be resolved by an entry point "
                         "(resolve_pipeline_cfg) before the run")


def _advance(arrs: dict, carry: RecolorCarry, keys: torch.Tensor,
             cfg: PipelineConfig, n_iters: int, exchange, comm,
             settle: bool) -> RecolorCarry:
    """Up to ``n_iters`` recoloring iterations of every running lane of
    ``carry`` (in place), each lane at its own iteration ``it``.

    Lane l's iteration ``it`` uses kind ``cfg.kind_ids[it - 1]`` and key
    ``fold_in(keys[l], it)``.  A lane that is not running is frozen: its
    chunk counts are zeroed (it colors nothing), it takes no exchange,
    its view is selected back after each iteration (``recolor_steps``
    builds the new view from zero) and it gets no history row.  Each
    iteration reads the device once, for its schedule, whose class count
    is the previous iteration's distinct-color count: the stop of a lane
    is decided there.  The history rows cross to the host in one read at
    the end; ``settle=True`` also decides the stop of the last iteration
    from that read, so the carry's ``best``/``stall`` are current (the
    stepped form), where the one-shot loop has no use for them.  On a 2D
    mesh a rank whose lanes are all frozen keeps taking the
    ``lane_uniform`` decision until every batch row's lanes are.
    """
    rcfg = cfg.recolor
    L = comm.L
    dev = carry.view.device
    n_local_max = arrs["indptr"].shape[1] - 1
    mc = rcfg.max_colors
    K = cfg.n_iters
    patience = _patience(cfg)
    n_rounds = 0 if exchange.broadcast else exchange.n_rounds
    view, sizes, n_oor = carry.view, carry.sizes, carry.n_oor
    schedule = cfg.kind_ids
    on = _lane_on(carry, cfg)
    pending = [False] * L    # ran an iteration whose stop is not decided
    masks = None             # (on, per-lane ints, per-row bools) on device
    rows = []

    def fold(lane: int, n: int) -> None:
        """Lane ``lane``'s last iteration left ``n`` distinct colors."""
        pending[lane] = False
        carry.stall[lane] = (0 if n < carry.best[lane]
                             else carry.stall[lane] + 1)
        carry.best[lane] = min(carry.best[lane], n)
        if carry.stall[lane] >= patience:
            on[lane] = False

    for _ in range(n_iters):
        if not comm.lane_uniform(any(on)):
            break
        if not any(on):      # a lane of another batch row still runs
            comm.wait_lanes()
            break
        # a trip whose schedule read trips the adaptive stop of every lane
        # ends in the span without recoloring
        with tracing.span("recolor.iteration"):
            kind_ids = [schedule[min(it, K) - 1] for it in carry.it]
            kinds = [ALL_PERMS[k] for k in kind_ids]
            live = {kinds[lane] for lane in range(L) if on[lane]}
            # a frozen lane's rank is never used: it takes a running kind
            kind = (live.pop() if len(live) == 1 else
                    [k if o else kinds[on.index(True)]
                     for k, o in zip(kinds, on)])
            rand_key = None
            if RAND in (kind if isinstance(kind, list) else [kind]):
                its = carry.it
                rand_key = rng.fold_in(keys, its[0] if len(set(its)) == 1
                                       else torch.tensor(its, device=dev))
            with tracing.span("recolor.schedule"):
                n_classes = (sizes > 0).sum(dim=1)
                rank = permutation_rank(sizes, kind, rand_key)
                sched = recolor_schedule(arrs, view, rank, n_classes, rcfg,
                                         n_rounds, comm)
            for lane in range(L):
                if pending[lane]:
                    fold(lane, sched.n_classes[lane])
            if not any(on):
                continue
            if not all(on) and (masks is None or masks[0] != on):
                lane_ints = torch.tensor(on, dtype=torch.int32, device=dev)
                masks = (list(on), lane_ints[:, None],
                         comm.per_shard(lane_ints.bool())[:, None])
            if masks is not None:
                sched.class_chunks.mul_(masks[1])
            new_view, st = recolor_steps(arrs, sched, exchange, rcfg,
                                         lanes_on=None if all(on) else on,
                                         comm=comm)
            view = new_view if masks is None else torch.where(
                masks[2], new_view, view)
            sizes, oor_next = class_sizes(view, arrs["n_local"], n_local_max,
                                          mc, lanes=L, comm=comm)
            dev_part = torch.stack([st["n_colors"].long(),
                                    (sizes > 0).sum(dim=1), n_oor.long()])
            host = [(carry.it[lane], (st["n_colors_before"][lane],
                                      st["n_exchanges"][lane],
                                      st["n_steps"][lane],
                                      st["wire_bytes"][lane], kind_ids[lane]))
                    if on[lane] else None for lane in range(L)]
            rows.append((dev_part, host))
            for lane in range(L):
                if on[lane]:
                    carry.it[lane] += 1
                    pending[lane] = True
                    if carry.it[lane] > K:
                        on[lane] = False
            n_oor = oor_next
    else:
        comm.wait_lanes()    # the batch rows leave the loop together
    if rows:
        with tracing.span("read.history"):
            vals = torch.stack([d for d, _ in rows]).tolist()  # the one read
        for (n_colors, nd, oor), (_, host) in zip(vals, rows):
            for lane, h in enumerate(host):
                if h is not None:
                    it, (before, n_ex, n_steps, wire, kid) = h
                    carry.hist[lane, it - 1] = (
                        n_colors[lane], nd[lane], before, n_ex, n_steps,
                        wire, oor[lane], kid, 1)
        if settle:
            for lane in range(L):
                if pending[lane]:      # it ran the last iteration
                    fold(lane, vals[-1][1][lane])
    carry.view, carry.sizes, carry.n_oor = view, sizes, n_oor
    return carry


def recolor_lanes(arrs: dict, view: torch.Tensor, keys, cfg: PipelineConfig,
                  lanes: int = 1, comm=None):
    """K recoloring iterations of ``lanes`` graphs laid end to end on the
    shard axis, each lane with its own adaptive stop.

    ``keys`` ``(L, 2)``: lane l's iteration ``it`` uses ``fold_in(keys[l],
    it)``.  A lane whose ``patience`` stop trips is frozen (``_advance``).
    ``comm``: the lanes' ``AxisComm``, or on a mesh the rank's
    ``MeshComm``.  Returns ``(view, histories, n_iters_run)``: one history
    list (of dicts) and one iteration count per lane.
    """
    _check_resolved(cfg)
    comm = lane_comm(arrs, lanes, comm)
    L = comm.L
    keys = torch.as_tensor(keys).reshape(L, 2).to(view.device)
    carry = recolor_carry_init(arrs, view, cfg, lanes=L, comm=comm)
    exchange = make_exchange(arrs, cfg.recolor.comm_config, lanes=L,
                             comm=comm)
    _advance(arrs, carry, keys, cfg, cfg.n_iters, exchange, comm,
             settle=False)
    return (carry.view, [carry.history(lane) for lane in range(L)],
            [it - 1 for it in carry.it])


def pipeline_carry(arrs: dict, order: torch.Tensor, color_key,
                   cfg: PipelineConfig, comm=None):
    """The initial coloring of one graph packed into a recolor carry, for
    stepped execution (the reference's ``pipeline_carry_spmd``): the
    serving engine's lane admission.  Returns ``(carry, color_stats)``;
    advance the carry with ``pipeline_step``."""
    if cfg.color is None:
        raise ValueError("pipeline_carry needs cfg.color")
    _check_resolved(cfg)
    view, cstats = color_lanes(arrs, order, color_key, cfg.color, comm=comm)
    return recolor_carry_init(arrs, view, cfg, comm=comm), cstats[0]


def pipeline_step(arrs: dict, carry: RecolorCarry, keys, cfg: PipelineConfig,
                  chunk: int, *, exchange=None, comm=None):
    """Advance every running lane of ``carry`` by ``chunk`` recoloring
    iterations (the reference's ``pipeline_step_spmd`` over the lanes of
    ``arrs``); returns ``(carry, done)``, ``done`` one bool per lane.

    A lane that is done (its stop tripped, all K ran, or an empty engine
    lane at ``it = K + 1``) is frozen, so stepping past its stop changes
    nothing: stepping until every lane is done gives bitwise what
    ``recolor_lanes`` gives, for any chunk and whatever lanes join
    between steps.  ``done`` is the reference's, right after the chunk:
    the last iteration's stop is decided from the step's one read of its
    history rows.  ``exchange`` — the lanes' ``FlatExchange``, when the
    caller keeps one (built from ``arrs`` otherwise).  The carry is
    updated in place.
    """
    if chunk < 1:
        raise ValueError("chunk must be >= 1")
    _check_resolved(cfg)
    L = carry.lanes
    comm = lane_comm(arrs, L, comm)
    if cfg.n_iters > 0:
        if exchange is None:
            exchange = make_exchange(arrs, cfg.recolor.comm_config, lanes=L,
                                     comm=comm)
        keys = torch.as_tensor(keys).reshape(L, 2).to(carry.view.device)
        _advance(arrs, carry, keys, cfg, chunk, exchange, comm, settle=True)
    return carry, ~np.array(_lane_on(carry, cfg), dtype=bool)


def recolor_loop(arrs: dict, view: torch.Tensor, key, cfg: PipelineConfig):
    """K recoloring iterations with the adaptive stop (all shards of one
    graph): ``recolor_lanes`` with one lane.  Returns ``(view, history,
    n_iters_run)``."""
    view, hists, n_run = recolor_lanes(arrs, view, key, cfg)
    return view, hists[0], n_run[0]


def color_then_recolor(arrs: dict, order: torch.Tensor, color_key,
                       recolor_key, cfg: PipelineConfig):
    """Initial speculative coloring + K recoloring iterations of one graph.

    Returns ``(view, color_stats, history, n_iters_run)``.
    """
    if cfg.color is None:
        raise ValueError("color_then_recolor needs cfg.color")
    view, cstats = color_lanes(arrs, order, color_key, cfg.color)
    view, history, n_run = recolor_loop(arrs, view, recolor_key, cfg)
    return view, cstats[0], history, n_run


def resolve_pipeline_cfg(pg: PartitionedGraph,
                         cfg: PipelineConfig) -> PipelineConfig:
    """Concretize any ``scheme="auto"`` stage against ``pg``'s comm plan."""
    if not cfg.has_auto:
        return cfg
    return dataclasses.replace(
        cfg, color=None if cfg.color is None else resolve_cfg(pg, cfg.color),
        recolor=resolve_cfg(pg, cfg.recolor))


# ---------------------------------------------------- program signatures --

@dataclasses.dataclass(frozen=True)
class PlanSignature:
    """Hashable identity of one pipeline dispatch (the reference's
    compiled-program key, with the same fields).

    ``rungs`` is the comm plan's static ``(shifts, pow2 widths)``,
    ``scheme`` the resolved exchange scheme, ``batch`` the lane count (0 =
    one graph), ``dims`` every input array's ``(name, shape, dtype)``,
    ``axes`` the mesh's ``((name, size), …)`` or the simulator's implied
    shard axis ``(("workers", P),)``, ``cfg`` the resolved config;
    ``extra`` the ``DeviceMesh`` of a sharded program (None in the sim).
    """

    kind: str          # pipe_sim | loop_sim | many_sim | *_sharded | engine_*
    P: int
    n_local_max: int
    maxd: int
    max_colors: int
    distance: int
    scheme: str        # resolved: "sparse" | "allgather"
    rungs: tuple       # plan static (shifts, pow2 widths); () for allgather
    batch: int         # graph lanes (0 = solo)
    cfg: object        # resolved PipelineConfig
    dims: tuple        # ((name, shape, dtype), ...) of every input array
    axes: tuple = ()
    extra: object = None

    def describe(self) -> str:
        """The human-readable core."""
        axes = "×".join(f"{n}={s}" for n, s in self.axes) or "-"
        return (f"kind={self.kind} P={self.P} "
                f"n_local_max={self.n_local_max} maxd={self.maxd} "
                f"max_colors={self.max_colors} distance={self.distance} "
                f"scheme={self.scheme} batch={self.batch} axes={axes} "
                f"rungs={self.rungs[1] if self.rungs else ()}")


@dataclasses.dataclass
class _Program:
    """What a signature alone decides: the resolved config and the lanes'
    ``AxisComm`` (whose index maps it keeps per device), or on a mesh the
    rank's ``MeshComm`` (its process groups)."""

    cfg: PipelineConfig
    comm: object


class _ProgramCache:
    """Process-wide LRU of ``_Program`` entries keyed on ``PlanSignature``.

    PyTorch compiles nothing, so an entry holds only what depends on the
    signature alone (the lane index maps); device inputs are cached on
    the partition or bucket instead.  ``hits``/``misses`` count signature
    lookups; ``traces`` counts entry builds (a miss builds one, so it
    equals ``misses`` since the last clear).
    """

    def __init__(self, maxsize: int = 128):
        self._fns: OrderedDict = OrderedDict()
        self.maxsize = maxsize
        self.hits = self.misses = self.traces = 0

    def get(self, sig: PlanSignature, build):
        fn = self._fns.get(sig)
        if fn is not None:
            self._fns.move_to_end(sig)
            self.hits += 1
            return fn
        self.misses += 1
        self.traces += 1
        fn = build()
        self._fns[sig] = fn
        while len(self._fns) > self.maxsize:
            self._fns.popitem(last=False)
        return fn

    def clear(self):
        self._fns.clear()
        self.hits = self.misses = self.traces = 0


_PROGRAMS = _ProgramCache()


def program_cache_stats() -> dict:
    """Snapshot of the process-wide program cache counters."""
    return dict(hits=_PROGRAMS.hits, misses=_PROGRAMS.misses,
                traces=_PROGRAMS.traces, size=len(_PROGRAMS._fns))


def program_cache_clear() -> None:
    """Drop every cached entry and zero the counters."""
    _PROGRAMS.clear()


def program_cache_contains(sig: PlanSignature) -> bool:
    """Cache probe with no counter side effects."""
    return sig in _PROGRAMS._fns


def _dtype_name(v) -> str:
    if isinstance(v, torch.Tensor):
        return str(v.dtype).removeprefix("torch.")
    return str(np.asarray(v).dtype)


def _dims_of(arrs) -> tuple:
    return tuple(sorted((k, tuple(v.shape), _dtype_name(v))
                        for k, v in arrs.items()))


def _mesh_axes_or_sim(mesh, P: int) -> tuple:
    """Signature ``axes``: the mesh's layout, or the simulator's implied
    shard axis of size P."""
    return ((AXIS, P),) if mesh is None else mesh_axes(mesh)


def _signature(kind: str, P: int, cfg: PipelineConfig, plan_static, dims,
               batch: int = 0, mesh=None) -> PlanSignature:
    mc = (cfg.color.max_colors if cfg.color is not None
          else cfg.recolor.max_colors)
    d = dict((name, shape) for name, shape, _ in dims)
    return PlanSignature(
        kind=kind, P=P, n_local_max=int(d["indptr"][-1]) - 1,
        maxd=int(d["nbr"][-1]), max_colors=mc,
        distance=cfg.recolor.distance, scheme=cfg.recolor.scheme,
        rungs=plan_static if plan_static is not None else (),
        batch=batch, cfg=cfg, dims=dims, axes=_mesh_axes_or_sim(mesh, P),
        extra=mesh)


def _plan_static(pg: PartitionedGraph, cfg: PipelineConfig):
    return pg.comm_plan.static if cfg.needs_sparse_plan else None


def plan_signature(pg: PartitionedGraph, cfg: PipelineConfig, *,
                   kind: str | None = None, batch: int = 0,
                   mesh=None) -> PlanSignature:
    """The signature a ``pipeline_sim``-family dispatch of ``pg`` uses
    (resolves "auto"; nothing runs).  ``mesh`` selects the
    ``pipeline_sharded`` program (``kind`` defaults accordingly)."""
    if kind is None:
        kind = "pipe_sim" if mesh is None else "pipe_sharded"
    cfg = resolve_pipeline_cfg(pg, cfg)
    dims = _dims_of(pg.arrays(sparse=cfg.needs_sparse_plan))
    return _signature(kind, pg.P, cfg, _plan_static(pg, cfg), dims,
                      batch=batch, mesh=mesh)


def _bucket_scheme(bucket: GraphBucket) -> str:
    """The sparse-vs-allgather pick for one bucket (union plan)."""
    sparse_b = sum(bucket.plan_static[1]) * 4
    ag_b = allgather_bytes_per_exchange(bucket.P,
                                        bucket.members[0].max_boundary)
    return SPARSE if sparse_b <= ag_b else ALLGATHER


def _resolve_bucket_cfg(bucket: GraphBucket,
                        cfg: PipelineConfig) -> PipelineConfig:
    """Per-bucket "auto" resolution: the members share one schedule, so
    the decision is made once from the union plan's padded bytes."""
    if not cfg.has_auto:
        return cfg
    scheme = _bucket_scheme(bucket)
    fix = lambda c: (None if c is None else
                     dataclasses.replace(c, scheme=scheme)
                     if c.scheme == AUTO else c)
    return dataclasses.replace(cfg, color=fix(cfg.color),
                               recolor=fix(cfg.recolor))


def _lane_target(B: int, pad_batch: bool, lane_multiple: int = 1) -> int:
    """Padded lane count: the next power of two under ``pad_batch``, and
    always a multiple of ``lane_multiple`` (a mesh's batch axis, which
    splits the lanes)."""
    t = _ceil_pow2(B) if pad_batch else B
    return -(-t // lane_multiple) * lane_multiple


def bucket_signature(bucket: GraphBucket, cfg: PipelineConfig, *,
                     pad_batch: bool = True, mesh=None) -> PlanSignature:
    """The signature a ``color_many`` (``mesh``: ``color_many_sharded``)
    dispatch of ``bucket`` uses (batch padding and the sharded layout's
    ``(P, B, …)`` axes applied to shapes only; nothing is stacked or
    run)."""
    bcfg = _resolve_bucket_cfg(bucket, cfg)
    ma = bucket.member_arrays(0, sparse=bcfg.needs_sparse_plan)
    B = _lane_target(bucket.B, pad_batch,
                     1 if mesh is None else batch_axis_size(mesh))

    def dim(v):
        s = (B,) + tuple(v.shape)
        return s if mesh is None else (s[1], s[0]) + s[2:]

    dims = tuple(sorted((k, dim(v), str(np.asarray(v).dtype))
                        for k, v in ma.items()))
    ps = bucket.plan_static if bcfg.needs_sparse_plan else None
    return _signature("many_sim" if mesh is None else "many_sharded",
                      bucket.P, bcfg, ps, dims, batch=B, mesh=mesh)


def _program(sig: PlanSignature, lanes: int) -> _Program:
    """The cache entry of ``sig``; ``lanes`` is the lane count one device
    holds (on a mesh: one batch row's)."""
    return _PROGRAMS.get(sig, lambda: _Program(
        cfg=sig.cfg, comm=AxisComm(sig.P, lanes) if sig.extra is None
        else MeshComm(sig.extra, lanes)))


# ----------------------------------------------- continuous-engine programs --

def _engine_sig(kind: str, P: int, cfg: PipelineConfig, plan_static, arrs,
                batch: int, mesh) -> PlanSignature:
    if cfg.has_auto:
        raise ValueError("the engine programs take a resolved config")
    return _signature(kind, P, cfg, plan_static, _dims_of(arrs), batch=batch,
                      mesh=mesh)


def _local_lanes(B: int, mesh) -> int:
    """Lanes of a B-lane engine one device holds."""
    return B if mesh is None else B // batch_axis_size(mesh)


def engine_init_program(P: int, cfg: PipelineConfig, plan_static, arrs,
                        mesh=None):
    """Cached one-lane admission program of a serving engine:
    ``(arrs, order, color_key) -> (carry, color_stats)`` (``pipeline_carry``).

    ``arrs`` is the lane's input dict (host or device; on a mesh this
    rank's one row), used for the signature (kind ``engine_init``).  The
    entry keeps the one-lane ``AxisComm`` (on a mesh, the rank's
    ``MeshComm``: the graph is replicated over a batch axis); an
    admission runs it once and puts the result into its lane
    (``engine_put_program``)."""
    sig = _engine_sig("engine_init", P, cfg, plan_static, arrs, 0, mesh)
    comm = _program(sig, 1).comm
    return lambda a, order, ck: pipeline_carry(a, order, ck, cfg, comm=comm)


def engine_step_program(P: int, cfg: PipelineConfig, plan_static, arrs,
                        B: int, chunk: int, mesh=None):
    """Cached all-lanes step program of a serving engine: ``(arrs, carry,
    keys, exchange=None) -> (carry, done)``, every running lane of the
    buffers ``arrs`` advanced by ``chunk`` iterations (``pipeline_step``;
    signature kind ``engine_step{chunk}``).  The buffers hold ``(B·P,
    …)`` rows, or on a mesh this rank's ``(B / batch, …)``: one shard of
    its batch row's lanes, whose ``done`` it returns.  Empty and finished
    lanes are frozen, so a partly idle engine steps its running lanes
    bitwise as they would run alone."""
    sig = _engine_sig(f"engine_step{chunk}", P, cfg, plan_static, arrs, B,
                      mesh)
    comm = _program(sig, _local_lanes(B, mesh)).comm
    return lambda a, carry, keys, exchange=None: pipeline_step(
        a, carry, keys, cfg, chunk, exchange=exchange, comm=comm)


def engine_put_program(P: int, cfg: PipelineConfig, plan_static, arrs,
                       B: int, mesh=None):
    """Cached lane-put program of a serving engine: ``(bufs, vals, b) ->
    bufs`` writes one admitted lane's arrays, carry and color stats
    (``vals = (arrs, carry, cstats)``, one lane) into lane ``b`` of the
    engine's ``(arrs, carry, cstats)`` buffers — rows ``b·P … (b+1)·P``
    of every ``(B·P, …)`` tensor (on a mesh: row ``b`` of this rank's
    lanes), row ``b`` of every per-lane one — in place, allocating
    nothing (signature kind ``engine_put``)."""
    sig = _engine_sig("engine_put", P, cfg, plan_static, arrs, B, mesh)
    rows = _program(sig, _local_lanes(B, mesh)).comm.shards
    return lambda bufs, vals, b: _put_lane(bufs, vals, b, rows)


def _put_lane(bufs, vals, b: int, P: int):
    (arrs, carry, cstats), (a1, c1, s1) = bufs, vals
    rows = slice(b * P, (b + 1) * P)
    for k, t in arrs.items():
        t[rows] = a1[k]
    carry.view[rows] = c1.view
    carry.sizes[b] = c1.sizes[0]
    carry.n_oor[b] = c1.n_oor[0]
    carry.hist[b] = c1.hist[0]
    for name in ("it", "best", "stall"):
        getattr(carry, name)[b] = getattr(c1, name)[0]
    cstats[b] = dict(s1)
    return bufs


# -------------------------------------------------------- entry points --

def recolor_loop_sim(pg: PartitionedGraph, view, cfg: PipelineConfig,
                     key=None, *, device=None):
    """The recolor-only loop of ``pg`` on one device (``cfg.color`` is not
    used): K iterations from the coloring ``view`` with the adaptive stop,
    ``recolor_iterations``' default path.

    ``key`` defaults to ``rng.key(cfg.seed)``; iteration ``it`` uses
    ``fold_in(key, it)``.  Returns ``(view, history, n_iters_run)``.
    """
    device = resolve_device(device)
    cfg = resolve_pipeline_cfg(pg, cfg)
    prog = _program(plan_signature(pg, cfg, kind="loop_sim"), 1)
    arrs = to_device(pg, device, sparse=cfg.needs_sparse_plan)
    view, hists, n_run = recolor_lanes(
        arrs, torch.as_tensor(view, device=device),
        rng.key(cfg.seed) if key is None else key, cfg, comm=prog.comm)
    return view, hists[0], n_run[0]


def pipeline_sim(pg: PartitionedGraph, order, cfg: PipelineConfig, *,
                 marked=None, color_key=None, recolor_key=None, device=None):
    """Run the color→recolor pipeline of ``pg`` on one device.

    ``order``/``marked`` as ``color_graph_sim``; ``color_key`` /
    ``recolor_key`` default to ``rng.key(cfg.color.seed)`` /
    ``rng.key(cfg.seed)``; ``device`` defaults to CUDA (``"cpu"`` runs the
    plain kernels on the CPU).
    Returns ``(view, result)``: the final ``(P, n_slots)`` view and
    ``result`` with the initial-coloring stats (``"color"``), one history
    dict per executed iteration (``"history"``), ``"n_iters_run"`` and
    the wall ``"seconds"`` of each stage (``to_device``, ``color``,
    ``recolor``).
    """
    if cfg.color is None:
        raise ValueError("pipeline_sim needs cfg.color")
    device = resolve_device(device)
    cfg = resolve_pipeline_cfg(pg, cfg)
    order = apply_partial(order, cfg.color, marked)
    ck = rng.key(cfg.color.seed) if color_key is None else color_key
    rk = rng.key(cfg.seed) if recolor_key is None else recolor_key
    prog = _program(plan_signature(pg, cfg), 1)
    # every stage ends in a device->host read, so host clocks at the stage
    # boundaries time the device work too
    t0 = time.perf_counter()
    arrs = to_device(pg, device, sparse=cfg.needs_sparse_plan)
    order = torch.as_tensor(order, device=device)
    t1 = time.perf_counter()
    view, cstats = color_lanes(arrs, order, ck, cfg.color, comm=prog.comm)
    t2 = time.perf_counter()
    view, hists, n_run = recolor_lanes(arrs, view, rk, cfg, comm=prog.comm)
    t3 = time.perf_counter()
    return view, dict(color=cstats[0], history=hists[0], n_iters_run=n_run[0],
                      seconds=dict(to_device=t1 - t0, color=t2 - t1,
                                   recolor=t3 - t2))


def pipeline_sharded(pg: PartitionedGraph, order, cfg: PipelineConfig, mesh,
                     *, marked=None, color_key=None, recolor_key=None):
    """``pipeline_sim`` on a mesh (a ``DeviceMesh`` over an initialised
    world, ``launch.mesh``): one shard of ``pg`` per rank of the shard
    axis, replicated over a batch axis.  Every rank passes the same
    arguments; each runs its shard's loops on its device, and returns the
    ``(P, n_slots)`` view gathered in shard order and the result of
    ``pipeline_sim`` (``seconds``: this rank's stage walls; the rest is
    bitwise ``pipeline_sim``'s on every rank)."""
    if cfg.color is None:
        raise ValueError("pipeline_sharded needs cfg.color")
    cfg = resolve_pipeline_cfg(pg, cfg)
    order = apply_partial(order, cfg.color, marked)
    ck = rng.key(cfg.color.seed) if color_key is None else color_key
    rk = rng.key(cfg.seed) if recolor_key is None else recolor_key
    prog = _program(plan_signature(pg, cfg, mesh=mesh), 1)

    def program(arrs, order, ck, rk, comm):
        t1 = time.perf_counter()
        view, cstats = color_lanes(arrs, order, ck, cfg.color, comm=comm)
        t2 = time.perf_counter()
        view, hists, n_run = recolor_lanes(arrs, view, rk, cfg, comm=comm)
        t3 = time.perf_counter()
        return (view,), [dict(color=cstats[0], history=hists[0],
                              n_iters_run=n_run[0],
                              seconds=dict(to_device=t1 - t0, color=t2 - t1,
                                           recolor=t3 - t2))]

    t0 = time.perf_counter()
    (view,), res = run_sharded(
        program, mesh, (pg.arrays(sparse=cfg.needs_sparse_plan),
                        np.asarray(order)), (ck, rk), comm=prog.comm)
    return view, res[0]


def _keys_many(cfg: PipelineConfig, n: int, color_keys, recolor_keys):
    """Per-graph key lists: the defaults fold the graph's input position
    into the config seeds, so a solo run with the same folded key
    reproduces its lane."""
    if color_keys is None:
        base = rng.key(cfg.color.seed)
        color_keys = [rng.fold_in(base, i) for i in range(n)]
    if recolor_keys is None:
        base = rng.key(cfg.seed)
        recolor_keys = [rng.fold_in(base, i) for i in range(n)]
    if len(color_keys) != n or len(recolor_keys) != n:
        raise ValueError(f"want {n} color and recolor keys, got "
                         f"{len(color_keys)} and {len(recolor_keys)}")
    return list(color_keys), list(recolor_keys)


def _bucket_order(bucket: GraphBucket, cfg: PipelineConfig, orders,
                  marked) -> np.ndarray:
    """``(B, P, n_local_max)`` visit order of one bucket's members.

    ``orders`` is an ordering-kind string (computed per padded member —
    the same as padding the original's order: local slots are unchanged)
    or a per-graph sequence of ``(P, n_local_max)`` arrays, padded here
    with -1 to the bucket width; ``marked`` masks are padded with False.
    Kind-string orders without masks are cached on the bucket.
    """
    cache = key = None
    if marked is None and (orders is None or isinstance(orders, str)):
        key = (orders, cfg.color)
        cache = bucket.__dict__.setdefault("_order_cache", {})
        if key in cache:
            return cache[key]
    rows = []
    for j, gi in enumerate(bucket.indices):
        m = bucket.members[j]
        if orders is None or isinstance(orders, str):
            o = compute_order(m, orders or ordering.INTERNAL_FIRST)
        else:
            o = np.asarray(orders[gi])
            o = np.pad(o, ((0, 0), (0, m.n_local_max - o.shape[1])),
                       constant_values=-1)
        mk = None if marked is None else marked[gi]
        if mk is not None:
            mk = np.asarray(mk, dtype=bool)
            mk = np.pad(mk, ((0, 0), (0, m.n_local_max - mk.shape[1])))
        rows.append(apply_partial(o, cfg.color, mk))
    out = np.stack(rows)
    if cache is not None:
        cache[key] = out
    return out


def _pad_batch_lanes(order_b, cks_b, rks_b, B: int, target: int):
    """Pad the lane axis up to ``target`` lanes with copies of member 0
    (their results are dropped), as ``graph.bucket_to_device`` pads the
    arrays."""
    ext = target - B
    if ext:
        order_b = np.concatenate(
            [order_b, np.repeat(order_b[:1], ext, axis=0)])
        cks_b = cks_b + [cks_b[0]] * ext
        rks_b = rks_b + [rks_b[0]] * ext
    return order_b, cks_b, rks_b


def _bucket_inputs(bucket: GraphBucket, cfg: PipelineConfig, orders, marked,
                   cks, rks, pad_batch: bool, device):
    """One bucket's device inputs: the ``(L·P, …)`` arrays (cached on the
    bucket), the ``(L·P, n_local_max)`` order and the ``(L, 2)`` keys."""
    L = _lane_target(bucket.B, pad_batch)
    arrs = bucket_to_device(bucket, device, sparse=cfg.needs_sparse_plan,
                            n_lanes=L)
    order_b = _bucket_order(bucket, cfg, orders, marked)
    order_b, cks_b, rks_b = _pad_batch_lanes(
        order_b, [cks[i] for i in bucket.indices],
        [rks[i] for i in bucket.indices], bucket.B, L)
    order_t = torch.as_tensor(order_b.reshape((-1,) + order_b.shape[2:]),
                              device=device)
    return arrs, order_t, torch.stack(cks_b), torch.stack(rks_b)


def _unpack_bucket(views, cstats, hists, n_run, bucket: GraphBucket,
                   bi: int, pgs, results) -> None:
    """``(L, P, n_slots)`` lane views and per-lane stats -> per-graph
    result dicts (input order)."""
    host = views.cpu().numpy()         # one device->host copy per bucket
    for j, gi in enumerate(bucket.indices):
        results[gi] = dict(
            view=views[j],
            colors=pgs[gi].gather_global_colors(
                host[j, :, :bucket.members[j].n_local_max]),
            color=cstats[j], history=hists[j], n_iters_run=n_run[j],
            bucket=bi)


def color_many(pgs, cfg: PipelineConfig, *, orders=None, marked=None,
               color_keys=None, recolor_keys=None, buckets=None,
               pad_batch: bool = False, device=None):
    """Color a batch of partitioned graphs, one lane-batched run per shape
    bucket (the reference's ``color_many``).

    ``pgs`` — same-``P`` ``PartitionedGraph`` list (``halo`` per
    ``cfg``'s distance).  ``orders`` — an ``ordering`` kind string (default
    ``internal_first``) or per-graph ``(P, n_local_max)`` arrays;
    ``marked`` — per-graph partial-coloring masks (``cfg.color.partial``);
    ``color_keys``/``recolor_keys`` — per-graph ``rng`` keys, by default
    the graph's input position folded into the config seeds; ``buckets``
    — a precomputed ``bucket_graphs(pgs)`` (graphs of no given bucket get
    ``None``); ``pad_batch=True`` rounds every bucket's lane count up to a
    power of two with dropped copies of its first member; ``device`` —
    default CUDA, ``"cpu"`` runs the plain kernels on the CPU.

    Returns one dict per input graph (input order): ``view`` ``(P,
    n_slots)`` padded device view, ``colors`` ``(n_global,)`` numpy,
    ``color`` initial-coloring stats, ``history``/``n_iters_run`` as
    ``pipeline_sim``, and the ``bucket`` index.  Each graph's view and
    stats are bitwise a solo ``pipeline_sim`` run on its padded member
    (``bucket.members[j]``) with the same keys.
    """
    if cfg.color is None:
        raise ValueError("color_many needs cfg.color")
    device = resolve_device(device)
    pgs = list(pgs)
    if buckets is None:
        buckets = bucket_graphs(pgs)
    cks, rks = _keys_many(cfg, len(pgs), color_keys, recolor_keys)
    results = [None] * len(pgs)
    for bi, bucket in enumerate(buckets):
        sig = bucket_signature(bucket, cfg, pad_batch=pad_batch)
        prog = _program(sig, sig.batch)
        bcfg = prog.cfg
        arrs, order, ck, rk = _bucket_inputs(bucket, bcfg, orders, marked,
                                             cks, rks, pad_batch, device)
        L = sig.batch
        view, cstats = color_lanes(arrs, order, ck, bcfg.color, lanes=L,
                                   comm=prog.comm)
        view, hists, n_run = recolor_lanes(arrs, view, rk, bcfg, lanes=L,
                                           comm=prog.comm)
        _unpack_bucket(view.view((L, bucket.P) + view.shape[1:]), cstats,
                       hists, n_run, bucket, bi, pgs, results)
    return results


def color_many_sharded(pgs, cfg: PipelineConfig, mesh, *, orders=None,
                       marked=None, color_keys=None, recolor_keys=None,
                       buckets=None, pad_batch: bool = False):
    """``color_many`` on a mesh (a ``DeviceMesh``, ``launch.mesh``): each
    bucket runs as ``(P, B, …)`` arrays, dim 0 over the shard axis and, on
    a 2D ``batch × shard`` mesh, dim 1 over the batch axis (each rank
    holds one shard of ``B / batch`` lanes; the lane count is padded to a
    multiple of the batch axis).  Every rank passes the same arguments and
    returns the same per-graph results, bitwise ``color_many``'s (the
    ``view`` is gathered in shard order)."""
    if cfg.color is None:
        raise ValueError("color_many_sharded needs cfg.color")
    pgs = list(pgs)
    if buckets is None:
        buckets = bucket_graphs(pgs)
    cks, rks = _keys_many(cfg, len(pgs), color_keys, recolor_keys)
    n_batch = batch_axis_size(mesh)
    results = [None] * len(pgs)
    for bi, bucket in enumerate(buckets):
        sig = bucket_signature(bucket, cfg, pad_batch=pad_batch, mesh=mesh)
        L = sig.batch
        prog = _program(sig, L // n_batch)
        bcfg = prog.cfg
        order_b, cks_b, rks_b = _pad_batch_lanes(
            _bucket_order(bucket, bcfg, orders, marked),
            [cks[i] for i in bucket.indices],
            [rks[i] for i in bucket.indices], bucket.B, L)
        st = bucket.stacked_arrays(sparse=bcfg.needs_sparse_plan)
        ext = L - bucket.B
        # the sharded layout: (P, L, …), pad lanes copying member 0
        arrs = {k: np.moveaxis(np.concatenate(
            [v, np.repeat(v[:1], ext, axis=0)]) if ext else v, 0, 1)
            for k, v in st.items()}

        def program(arrs, order, ck, rk, comm):
            view, cstats = color_lanes(arrs, order, ck, bcfg.color,
                                       lanes=comm.L, comm=comm)
            view, hists, n_run = recolor_lanes(arrs, view, rk, bcfg,
                                               lanes=comm.L, comm=comm)
            return (view,), list(zip(cstats, hists, n_run))

        (view,), lanes = run_sharded_many(
            program, mesh, (arrs, np.moveaxis(order_b, 0, 1)),
            (torch.stack(cks_b), torch.stack(rks_b)), comm=prog.comm)
        cstats, hists, n_run = zip(*lanes)
        _unpack_bucket(view.transpose(0, 1).contiguous(), cstats, hists,
                       n_run, bucket, bi, pgs, results)
    return results
