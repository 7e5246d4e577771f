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
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict

import numpy as np
import torch

from repro_torch import rng

from . import ordering
from .comm import (ALLGATHER, AUTO, SPARSE, AxisComm,
                   allgather_bytes_per_exchange, make_exchange, sparse_rounds)
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
AXIS = "workers"   # the reference's shard axis name, in the signature's axes


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

def recolor_lanes(arrs: dict, view: torch.Tensor, keys, cfg: PipelineConfig,
                  lanes: int = 1, comm: AxisComm | None = None):
    """K recoloring iterations of ``lanes`` graphs laid end to end on the
    shard axis, each lane with its own adaptive stop.

    ``keys`` ``(L, 2)``: lane l's iteration ``it`` uses ``fold_in(keys[l],
    it)``.  A lane whose ``patience`` stop trips is frozen: its chunk
    counts are zeroed (it colors nothing), it takes no exchange, its view
    is selected back after each iteration (``recolor_steps`` builds the
    new view from zero) and it gets no history row.  Returns ``(view,
    histories, n_iters_run)``: one history list (of dicts) and one
    iteration count per lane.
    """
    rcfg = cfg.recolor
    if rcfg.scheme == AUTO:
        raise ValueError("scheme='auto' must be resolved by an entry point "
                         "(resolve_pipeline_cfg) before the run")
    comm = lane_comm(arrs, lanes, comm)
    L, P = comm.L, comm.P
    dev = view.device
    keys = torch.as_tensor(keys).reshape(L, 2).to(dev)
    n_local_max = arrs["indptr"].shape[1] - 1
    mc = rcfg.max_colors
    K = cfg.n_iters
    patience = cfg.patience if cfg.patience else K + 1   # K+1 never trips
    exchange = make_exchange(arrs, rcfg.comm_config, lanes=L)
    n_rounds = sparse_rounds(arrs)
    sizes, n_oor = class_sizes(view, arrs["n_local"], n_local_max, mc,
                               lanes=L)
    best, stall, on = [INT32_MAX] * L, [0] * L, [True] * L
    on_lane = on_rows = None        # device masks, once a lane has stopped
    rows = []
    for it in range(1, K + 1):
        kind_id = cfg.kind_ids[it - 1]
        kind = ALL_PERMS[kind_id]
        n_classes = (sizes > 0).sum(dim=1)
        rank = permutation_rank(
            sizes, kind, rng.fold_in(keys, it) if kind == RAND else None)
        sched = recolor_schedule(arrs, view, rank, n_classes, rcfg, n_rounds)
        if it > 1:
            # this class count is the previous iteration's distinct colors
            for lane in range(L):
                if not on[lane]:
                    continue
                n = sched.n_classes[lane]
                stall[lane] = 0 if n < best[lane] else stall[lane] + 1
                best[lane] = min(best[lane], n)
                if stall[lane] >= patience:
                    on[lane] = False
                    if on_lane is None:
                        on_lane = torch.ones((L, 1), dtype=torch.int32,
                                             device=dev)
                        on_rows = torch.ones((L * P, 1), dtype=torch.bool,
                                             device=dev)
                    on_lane[lane] = 0
                    on_rows[lane * P:(lane + 1) * P] = False
            if not any(on):
                break
        if on_lane is not None:
            sched.class_chunks.mul_(on_lane)
        new_view, st = recolor_steps(arrs, sched, exchange, rcfg,
                                     lanes_on=None if all(on) else on)
        view = new_view if on_rows is None else torch.where(
            on_rows, new_view, view)
        sizes, oor_next = class_sizes(view, arrs["n_local"], n_local_max, mc,
                                      lanes=L)
        dev_part = torch.stack([st["n_colors"].long(), (sizes > 0).sum(dim=1),
                                n_oor.long()])
        host = [dict(n_colors_before=st["n_colors_before"][lane],
                     n_exchanges=st["n_exchanges"][lane],
                     n_steps=st["n_steps"][lane],
                     wire_bytes=st["wire_bytes"][lane], perm_id=kind_id)
                for lane in range(L)]
        rows.append((dev_part, list(on), host))
        n_oor = oor_next
    return view, *_histories_to_host(rows, L)


def _histories_to_host(rows, L: int) -> tuple[list, list]:
    """Per-iteration rows -> (one history list per lane, its iteration
    count), with one device->host transfer for all device parts."""
    hists = [[] for _ in range(L)]
    if rows:
        dev = torch.stack([d for d, _, _ in rows]).tolist()
        for (n_colors, nd, oor), (_, on, host) in zip(dev, rows):
            for lane in range(L):
                if not on[lane]:
                    continue
                vals = dict(host[lane], n_colors=n_colors[lane],
                            n_colors_distinct=nd[lane],
                            n_out_of_range=oor[lane])
                row = {k: vals[k] for k in HISTORY_STATS if k != "ran"}
                row["perm"] = ALL_PERMS[row.pop("perm_id")]
                row["iteration"] = len(hists[lane]) + 1
                hists[lane].append(row)
    return hists, [len(h) for h in hists]


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
    ``axes`` the implied shard axis ``(("workers", P),)``, ``cfg`` the
    resolved config; ``extra`` is unused here (the reference's mesh).
    """

    kind: str          # pipe_sim | loop_sim | many_sim
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
    ``AxisComm``, whose index maps it keeps per device."""

    cfg: PipelineConfig
    comm: AxisComm


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


def _dims_of(arrs) -> tuple:
    return tuple(sorted((k, tuple(v.shape), str(np.asarray(v).dtype))
                        for k, v in arrs.items()))


def _signature(kind: str, P: int, cfg: PipelineConfig, plan_static, dims,
               batch: int = 0) -> PlanSignature:
    mc = (cfg.color.max_colors if cfg.color is not None
          else cfg.recolor.max_colors)
    d = dict((name, shape) for name, shape, _ in dims)
    return PlanSignature(
        kind=kind, P=P, n_local_max=int(d["indptr"][-1]) - 1,
        maxd=int(d["nbr"][-1]), max_colors=mc,
        distance=cfg.recolor.distance, scheme=cfg.recolor.scheme,
        rungs=plan_static if plan_static is not None else (),
        batch=batch, cfg=cfg, dims=dims, axes=((AXIS, P),))


def _plan_static(pg: PartitionedGraph, cfg: PipelineConfig):
    return pg.comm_plan.static if cfg.needs_sparse_plan else None


def plan_signature(pg: PartitionedGraph, cfg: PipelineConfig, *,
                   kind: str = "pipe_sim", batch: int = 0) -> PlanSignature:
    """The signature a ``pipeline_sim``-family dispatch of ``pg`` uses
    (resolves "auto"; nothing runs)."""
    cfg = resolve_pipeline_cfg(pg, cfg)
    dims = _dims_of(pg.arrays(sparse=cfg.needs_sparse_plan))
    return _signature(kind, pg.P, cfg, _plan_static(pg, cfg), dims,
                      batch=batch)


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


def _lane_target(B: int, pad_batch: bool) -> int:
    """Padded lane count: the next power of two under ``pad_batch``."""
    return _ceil_pow2(B) if pad_batch else B


def bucket_signature(bucket: GraphBucket, cfg: PipelineConfig, *,
                     pad_batch: bool = True) -> PlanSignature:
    """The signature a ``color_many`` dispatch of ``bucket`` uses (batch
    padding applied to shapes only; nothing is stacked or run)."""
    bcfg = _resolve_bucket_cfg(bucket, cfg)
    ma = bucket.member_arrays(0, sparse=bcfg.needs_sparse_plan)
    B = _lane_target(bucket.B, pad_batch)
    dims = tuple(sorted((k, (B,) + tuple(v.shape), str(np.asarray(v).dtype))
                        for k, v in ma.items()))
    ps = bucket.plan_static if bcfg.needs_sparse_plan else None
    return _signature("many_sim", bucket.P, bcfg, ps, dims, batch=B)


def _program(sig: PlanSignature, lanes: int) -> _Program:
    return _PROGRAMS.get(sig, lambda: _Program(
        cfg=sig.cfg, comm=AxisComm(sig.P, lanes)))


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


def _unpack_bucket(view, cstats, hists, n_run, bucket: GraphBucket,
                   bi: int, pgs, results) -> None:
    """``(L·P, …)`` lane outputs -> per-graph result dicts (input order)."""
    P = bucket.P
    host = view.cpu().numpy()          # one device->host copy per bucket
    for j, gi in enumerate(bucket.indices):
        rows = slice(j * P, (j + 1) * P)
        results[gi] = dict(
            view=view[rows],
            colors=pgs[gi].gather_global_colors(
                host[rows, :bucket.members[j].n_local_max]),
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
        _unpack_bucket(view, cstats, hists, n_run, bucket, bi, pgs, results)
    return results
