"""Continuous-batching coloring service on the lane-batched pipeline.

The port of ``repro.launch.serve_coloring``.  The paper's end use is
scheduling: color a conflict graph so each color class runs at once.  In
production that workload arrives as many small-to-medium graphs (a
conflict graph per batch, a sparsity pattern per tile), so the serving
shape is a queue of requests of mixed shapes, and per-graph latency is
the currency.

Two scheduling modes (``ServeConfig.mode``):

- ``"continuous"`` (default) — long-lived per-shape **engines** hold B
  lanes of ``(B·P, …)`` buffers (``core.engine_*_program``); a freed lane
  admits the next compatible request while the other lanes keep stepping:
  the new graph is padded to the engine's dims (``core.pad_partition``),
  its sparse plan laid onto the engine's schedule
  (``core.remap_plan_arrays``), colored in one lane, and put into the
  lane's rows with a fresh request-folded key.  ``submit`` returns a
  request id whose ``JobFuture`` resolves as the scheduler runs;
  **admission control** under a latency SLO picks per request: a solo
  dispatch (its program is cached), a lane, a shed or a deferral.  Every
  lane is bitwise a solo ``pipeline_sim`` of the same engine-padded
  member under any interleaving of admissions (``core.pipeline_step``
  freezes a lane that is done or empty).
- ``"flush"`` — the batch-synchronous router: a cached solo program
  dispatches at once, the rest are grouped by signature into
  ``core.color_many`` waves.

Request keys fold the *request id* into the config seeds, so a request's
coloring does not depend on the route, lane or batch position that
served it.  Time is read through an injectable clock (default
``WallClock``); tests drive the scheduler on a ``FakeClock`` with
scripted arrivals (``serve_harness``).  Device work runs on CUDA unless
the service is built with ``device="cpu"`` (the plain kernels).

**Mesh route** (``mesh=``, a ``launch.mesh.MeshSpec`` or a built
``DeviceMesh`` spanning the world): every rank runs the same service on
the same submissions.  Each engine allocates ``engine_lanes(mesh,
lanes)`` lanes, split over a batch axis, and every rank holds one shard of
its batch row's lanes; solo dispatches run ``core.pipeline_sharded``,
flush waves ``core.color_many_sharded``.  The first rank's clock is the
mesh's: every clock reading is broadcast from it, so the ranks take the
same admissions, sheds, steps and drains, and so the same collectives.

    python -m repro_torch.launch.serve_coloring --device cpu \\
        --graphs 8 --p 2 --iters 2
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import time
from collections import OrderedDict

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import rng
from repro_torch.core import (ColorConfig, Graph, MeshComm, PipelineConfig,
                              RecolorConfig, arrays_from_numpy,
                              bucket_graphs, bucket_signature,
                              check_coloring, color_many, color_many_sharded,
                              compute_order, engine_init_program,
                              engine_put_program, engine_step_program,
                              ordering, pad_partition, partition_graph,
                              pipeline_sharded, pipeline_sim, plan_fits,
                              plan_signature, program_cache_contains,
                              program_cache_stats, remap_plan_arrays,
                              resolve_pipeline_cfg, rmat)
from repro_torch.core.comm import make_exchange
from repro_torch.core.speculative import apply_partial, resolve_device
from repro_torch.launch.mesh import MeshSpec, engine_lanes


def default_config(*, max_colors: int = 1024, n_iters: int = 8,
                   distance: int = 1, patience: int = 2,
                   scheme: str | None = None) -> PipelineConfig:
    """The service's default pipeline: Random-X (X=10) seed coloring + ND
    recoloring with an adaptive stop.

    ``scheme=None`` follows ``$REPRO_SCHEME`` (default ``"auto"``): each
    bucket picks sparse or all-gather from the modeled wire bytes."""
    kw = {} if scheme is None else dict(scheme=scheme)
    return PipelineConfig(
        color=ColorConfig(max_colors=max_colors, superstep=512,
                          selection="random_x", random_x=10,
                          distance=distance, **kw),
        recolor=RecolorConfig(max_colors=max_colors, distance=distance, **kw),
        n_iters=n_iters, base_perm="nd", patience=patience)


# ------------------------------------------------------------------ clocks --

class WallClock:
    """Default time source: monotonic wall seconds (``time.perf_counter``).

    Any object with a ``now() -> float`` method is a valid clock — the
    scheduler never sleeps and never mixes clocks, so a scripted
    ``FakeClock`` replays exact interleavings."""

    def now(self) -> float:
        return time.perf_counter()


class FakeClock:
    """Deterministic manual clock for scheduler tests and virtual-time
    benchmarks: ``now()`` returns the scripted time, ``advance`` moves it.
    Nothing in the service reads wall time when one of these is injected,
    so SLO sheds and latency accounting are exactly reproducible."""

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"a clock cannot go back ({dt})")
        self._t += float(dt)
        return self._t


# --------------------------------------------------------- config + futures --

@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Scheduler knobs.

    ``mode`` — ``"continuous"`` (engine lanes + admission control) or
    ``"flush"`` (the batch-synchronous router).  ``lanes`` — lanes per
    engine.  ``chunk_iters`` — recoloring iterations per engine step;
    admission is interleaved between chunks, so smaller chunks admit
    sooner at the cost of more steps.  ``slo_s`` — latency SLO: a request
    whose queue age plus the engine's service-time estimate exceeds it is
    *shed* (``ShedError`` on its future); ``None`` disables shedding (jobs
    defer until a lane frees).  ``max_queue`` — queue-depth bound; submits
    past it shed at once.  ``max_engines`` — live engine cap (idle LRU
    engines are evicted to make room).  ``solo_warm`` — a request whose
    solo program is already cached dispatches at once, skipping the
    engine or the batch wave; ``False`` sends every request through
    engine lanes or batch waves.
    """

    mode: str = "continuous"
    lanes: int = 4
    chunk_iters: int = 2
    slo_s: float | None = None
    max_queue: int = 1024
    max_engines: int = 8
    solo_warm: bool = True

    def __post_init__(self):
        if self.mode not in ("continuous", "flush"):
            raise ValueError(f"bad mode {self.mode!r}")
        if self.lanes < 1 or self.chunk_iters < 1:
            raise ValueError("lanes and chunk_iters must be >= 1")
        if self.max_queue < 1 or self.max_engines < 1:
            raise ValueError("max_queue and max_engines must be >= 1")
        if self.slo_s is not None and self.slo_s <= 0:
            raise ValueError("slo_s must be > 0")


class JobError(RuntimeError):
    """A request failed inside its lane (invalid coloring, color-id
    saturation, leaked sentinels).  Carried by the job's future; the
    engine keeps draining its other lanes."""

    def __init__(self, job_id: int, msg: str):
        super().__init__(msg)
        self.job_id = job_id


class ShedError(JobError):
    """Admission control rejected the request (queue bound or SLO)."""


class JobFuture:
    """Completion handle for one submitted request.

    Single-threaded: ``result()`` *drives* the service's scheduler
    (``poll``) until the job resolves — no background thread, so results
    are deterministic under a ``FakeClock``.  A shed or failed job raises
    its ``ShedError``/``JobError`` from ``result()`` and exposes it via
    ``exception()``.
    """

    def __init__(self, svc: "ColoringService", job_id: int):
        self.id = job_id
        self._svc = svc
        self._out = None
        self._err: Exception | None = None
        self._resolved = False

    def done(self) -> bool:
        return self._resolved

    def exception(self) -> Exception | None:
        return self._err

    def result(self, max_polls: int = 100_000):
        polls = 0
        while not self._resolved:
            self._svc.poll()
            polls += 1
            if polls > max_polls:
                raise RuntimeError(f"request {self.id} did not resolve in "
                                   f"{max_polls} polls")
        if self._err is not None:
            raise self._err
        return self._out

    def _resolve(self, out, err: Exception | None):
        self._out, self._err, self._resolved = out, err, True


def _graph_fingerprint(g: Graph) -> str:
    """Content hash of a graph — the partition-memo key."""
    h = hashlib.blake2b(digest_size=16)
    h.update(np.int64(g.n).tobytes())
    h.update(np.ascontiguousarray(g.indptr).tobytes())
    h.update(np.ascontiguousarray(g.indices).tobytes())
    return h.hexdigest()


@dataclasses.dataclass
class _Job:
    id: int
    graph: Graph
    marked: np.ndarray | None
    t_submit: float = 0.0
    deferred: bool = False       # counted into n_deferred at most once


@dataclasses.dataclass
class _Entry:
    """Memoized per-unique-graph dispatch state (keyed by content hash)."""
    pg: object          # PartitionedGraph (original dims)
    bucket: object      # its one-graph GraphBucket (pow2-padded)
    signature: object   # the bucket's PlanSignature (batch grouping)
    solo_sig: object    # the padded member's pipeline_sim signature
    order: object       # visit order of the padded member (numpy)
    exact_sig: object   # the original dims' pipeline_sim signature
    exact_order: object  # visit order of the original partition
    # engine-padded (member, order, device arrays) per engine dims: a
    # repeat graph's admission pays no re-pad, re-order or copy
    engine_members: dict = dataclasses.field(default_factory=dict)

    @property
    def member(self):
        """The pow2-padded partition the solo path dispatches."""
        return self.bucket.members[0]


# ----------------------------------------------------------------- engine --

@dataclasses.dataclass
class _LaneJob:
    job: _Job
    member: object      # engine-padded PartitionedGraph
    t_admit: float


class _Engine:
    """One long-lived continuous-batching engine.

    Holds ``B`` lanes of ``(B·P, …)`` device buffers for one set of
    engine programs: fixed padded dims, fixed sparse schedule, fixed
    resolved config.  On a mesh the rank holds ``(B / batch, …)``: one
    shard of lanes ``b0 … b0 + B / batch - 1``, its batch row's; the
    lanes' done flags and results are gathered to every rank.  Lane
    life: **empty** (no job; its carry frozen at
    ``it = K+1``, so a step leaves it as it is) → **running** (an admitted
    request's arrays, carry and request-folded key put into its rows) →
    **done** (its stop tripped; drained to a result, empty again).  The
    exchange map of the lanes is rebuilt before the first step after an
    admission: a lane's send and receive lists are its graph's.
    """

    def __init__(self, svc: "ColoringService", entry: _Entry,
                 cfg: PipelineConfig, eid: int):
        m = entry.member
        self.svc = svc
        self.cfg = cfg                     # resolved: never "auto"
        self.eid = eid
        self.P, self.halo = m.P, m.halo
        self.dims = dict(n_local_max=m.n_local_max, max_ghost=m.max_ghost,
                         max_boundary=m.max_boundary,
                         m_local_max=m.m_local_max, maxd=m.maxd,
                         maxd2=m.maxd2)
        self.id_dtypes = (m.gvid.dtype, m.prio.dtype)
        self.sparse = cfg.needs_sparse_plan
        self.static = m.comm_plan.static if self.sparse else None
        self.mesh = svc.mesh
        self.B = engine_lanes(self.mesh, svc.serve.lanes)
        comm = svc._comm
        self.B_local = self.B if comm is None else self.B // comm.n_batch
        self.b0 = 0 if comm is None else comm.b * self.B_local
        # the exchanges' collectives over this rank's lanes
        self._comm = None if comm is None else MeshComm(self.mesh,
                                                        self.B_local)
        self.lanes: list[_LaneJob | None] = [None] * self.B
        self.n_running = 0
        self._arrs = self._carry = self._cstats = self._exchange = None
        self._lane_rkeys: list = [None] * self.B
        self.ewma_job_s: float | None = None
        self.last_used = svc._now()

    # ------------------------------------------------------------ admission --

    def accepts(self, entry: _Entry, cfg: PipelineConfig) -> bool:
        """Admission gate: can this engine run ``entry`` bitwise?

        The member must pad into the engine's dims, agree on P / halo /
        resolved config / id dtypes, and (sparse scheme) its comm plan
        must embed into the engine's schedule (``core.plan_fits``)."""
        m = entry.member
        if (m.P, m.halo) != (self.P, self.halo) or cfg != self.cfg:
            return False
        if (m.gvid.dtype, m.prio.dtype) != self.id_dtypes:
            return False
        if any(getattr(m, k) > v for k, v in self.dims.items()):
            return False
        if self.sparse and not plan_fits(m.comm_plan, self.static):
            return False
        return True

    def free_lane(self) -> int | None:
        for b, ln in enumerate(self.lanes):
            if ln is None:
                return b
        return None

    def estimate_s(self) -> float:
        """Service-time estimate for one more request: the EWMA of
        observed lane admit→drain times (0 until one is observed)."""
        return self.ewma_job_s or 0.0

    def admit(self, job: _Job, b: int, entry: _Entry, now: float) -> None:
        """Put ``job`` into free lane ``b``: pad the member to the engine
        dims, lay its sparse plan onto the engine schedule, color it in
        one lane (the init program) and put arrays, carry and the
        request-folded key into the lane's rows.  Running lanes are not
        touched."""
        svc = self.svc
        dims_key = tuple(sorted(self.dims.items()))
        cached = entry.engine_members.get(dims_key)
        if cached is None:
            member = pad_partition(entry.member, **self.dims)
            order = compute_order(member, svc.order_kind)
            host = member.arrays(sparse=False)
            if self.sparse:
                host.update(remap_plan_arrays(member, self.static))
            arrs = arrays_from_numpy(
                {k: v[svc._rows] for k, v in host.items()}, svc.device)
            cached = entry.engine_members[dims_key] = (member, order, arrs)
        member, order, arrs = cached
        marked = (svc._marked_blocks(member, job.marked)
                  if self.cfg.color.partial else None)
        order = torch.as_tensor(
            apply_partial(order, self.cfg.color, marked)[svc._rows],
            device=svc.device)
        cks, rks = svc._keys([job])
        # on a mesh every batch row colors the graph (replicated, as the
        # one-lane program runs over the shard axis alone); the row that
        # holds lane b keeps it
        init = engine_init_program(self.P, self.cfg, self.static, arrs,
                                   mesh=self.mesh)
        carry, cstats = init(arrs, order, cks[0])
        if self._arrs is None:
            self._alloc(arrs, carry, cstats)
        if self.b0 <= b < self.b0 + self.B_local:
            self._put(b - self.b0, arrs, carry, cstats)
        self._lane_rkeys[b] = rks[0]
        # never-admitted lanes need some key to stack; they are frozen
        self._lane_rkeys = [rks[0] if k is None else k
                            for k in self._lane_rkeys]
        self.lanes[b] = _LaneJob(job, member, now)
        self.n_running += 1
        self.last_used = now

    def _alloc(self, arrs, carry, cstats) -> None:
        """First admission: buffers of this device's lanes, each a copy of
        this lane, then every lane frozen at ``it = K+1`` until a job is
        put in."""
        B = self.B_local
        self._arrs = {k: v.repeat((B,) + (1,) * (v.dim() - 1))
                      for k, v in arrs.items()}
        self._carry = dataclasses.replace(
            carry, view=carry.view.repeat(B, 1), it=[self.cfg.n_iters + 1] * B,
            best=carry.best * B, stall=carry.stall * B,
            hist=np.repeat(carry.hist, B, axis=0),
            sizes=carry.sizes.repeat(B, 1), n_oor=carry.n_oor.repeat(B))
        self._cstats = [dict(cstats) for _ in range(B)]

    def _put(self, b: int, arrs, carry, cstats) -> None:
        prog = engine_put_program(self.P, self.cfg, self.static, arrs, self.B,
                                  mesh=self.mesh)
        prog((self._arrs, self._carry, self._cstats), (arrs, carry, cstats),
             b)
        self._exchange = None          # lane b's send/receive lists changed

    # ------------------------------------------------------------- stepping --

    def step(self) -> np.ndarray:
        """Advance every running lane by ``chunk_iters`` iterations.
        Returns the per-lane done mask (of all B lanes)."""
        prog = engine_step_program(self.P, self.cfg, self.static, self._arrs,
                                   self.B, self.svc.serve.chunk_iters,
                                   mesh=self.mesh)
        if self._exchange is None:
            self._exchange = make_exchange(
                self._arrs, self.cfg.recolor.comm_config, lanes=self.B_local,
                comm=self._comm)
        keys = torch.stack(
            self._lane_rkeys[self.b0:self.b0 + self.B_local]).to(
                self.svc.device)
        self._carry, done = prog(self._arrs, self._carry, keys,
                                 exchange=self._exchange)
        return done if self._comm is None else np.array(
            self._comm.gather_objects(done.tolist()), dtype=bool)

    def _lane_results(self):
        """Every lane's ``(P, n_slots)`` host view, history, iteration
        count and color stats (on a mesh: gathered from every rank)."""
        carry, comm = self._carry, self.svc._comm
        per = [(carry.history(b), carry.it[b], self._cstats[b])
               for b in range(self.B_local)]
        if comm is None:
            views = carry.view.reshape(self.B, self.P, -1).cpu().numpy()
            return views, per
        views = comm.gather_lanes(carry.view).transpose(0, 1).cpu().numpy()
        return views, comm.gather_objects(per)

    def drain(self, done: np.ndarray, now: float, results: dict) -> None:
        """Unpack every done running lane to a result and free it.

        Fault isolation: a lane that leaked uncolored sentinels, saturated
        the color ids (``n_out_of_range``) or produced an invalid coloring
        fails only its own job — the error lands on that job's future and
        the engine keeps running its other lanes."""
        svc = self.svc
        todo = [b for b in range(self.B)
                if self.lanes[b] is not None and done[b]]
        if not todo:
            return
        views, per = self._lane_results()
        for b in todo:
            ln = self.lanes[b]
            view = views[b]
            history, it, cstats = per[b]
            self.lanes[b] = None
            self.n_running -= 1
            self.last_used = now
            dt = now - ln.t_admit
            self.ewma_job_s = (dt if self.ewma_job_s is None
                               else 0.7 * self.ewma_job_s + 0.3 * dt)
            member = ln.member
            colors = member.gather_global_colors(view[:, :member.n_local_max])
            out = dict(
                colors=colors,
                n_colors=(history[-1]["n_colors_distinct"] if history else
                          cstats["n_colors_distinct"]),
                color=dict(cstats), history=history,
                n_iters_run=it - 1,
                bucket=self.eid, route="engine", member=member, cfg=self.cfg,
                latency_s=now - ln.job.t_submit)
            err = None
            if (colors <= 0).any():
                err = (f"request {ln.job.id}: lane leaked "
                       f"{int((colors <= 0).sum())} uncolored sentinels")
            elif (any(row["n_out_of_range"] for row in history)
                  or cstats.get("n_out_of_range", 0) > 0):
                err = (f"request {ln.job.id}: color-id saturation "
                       f"(past max_colors={self.cfg.recolor.max_colors})")
            if svc.validate or err:
                out["check"] = check_coloring(
                    ln.job.graph, np.maximum(colors, 1),
                    distance=self.cfg.recolor.distance, marked=ln.job.marked)
                if err:
                    out["check"] = dict(out["check"], valid=False)
                elif not out["check"]["valid"]:
                    err = (f"request {ln.job.id}: invalid coloring "
                           f"({out['check']})")
            if err:
                out["error"] = err
                svc._fail(ln.job, out, err, results)
            else:
                svc._complete(ln.job, out, results)
                svc._n_lane += 1


class ColoringService:
    """Queue graphs, color them via the continuous scheduler, return by id.

    ``submit`` enqueues a ``core.Graph`` (plus an optional per-vertex
    ``marked`` mask when the config is partial) and returns a request id;
    ``submit_async`` also returns the request's ``JobFuture``.  In
    continuous mode ``poll`` runs one scheduler step — admit queued
    requests into free engine lanes (or solo-dispatch warm ones, or shed
    per the SLO), advance every active engine one chunk, drain finished
    lanes — and returns the results completed during the call; ``flush``
    polls until the queue and all lanes drain and returns every result
    since the last flush.  In ``"flush"`` mode the batch-synchronous
    router runs instead.

    Each result carries ``colors`` ``(n,)`` 1-based, ``n_colors``, the
    per-iteration ``history``, ``n_iters_run``, the ``route``
    (``"engine"``/``"solo"``/``"batch"``), its ``latency_s`` (continuous:
    arrival→completion on the service clock; flush: the dispatch's clock
    time) and (``validate=True``) a ``check_coloring`` report.  Failed
    jobs appear with an ``"error"`` key and raise ``JobError`` from their
    future; shed jobs produce no result — their future raises
    ``ShedError``.

    ``device`` — default CUDA (raises without it), ``"cpu"`` runs the
    plain kernels.  ``mesh`` — ``None`` (one device), or a ``MeshSpec``
    (built for ``device``'s type) or ``DeviceMesh`` spanning the world,
    whose shard axis must have ``P`` ranks: the mesh route (module
    docstring); the mesh's device is the service's.  ``clock`` injects a
    time source (``FakeClock`` for
    deterministic tests).  ``stats()`` exposes the scheduler counters and
    the process-wide program-cache counters.
    """

    def __init__(self, *, P: int = 4, cfg: PipelineConfig | None = None,
                 order_kind: str = ordering.INTERNAL_FIRST, mesh=None,
                 max_batch: int = 64, validate: bool = False, seed: int = 0,
                 memo_graphs: int = 256, serve: ServeConfig | None = None,
                 clock=None, device=None):
        self._comm = None
        self._rows = slice(None)        # this device's rows of a partition
        if isinstance(mesh, MeshSpec):
            mesh = mesh.build("cpu" if device is not None and
                              torch.device(device).type == "cpu" else None)
        if mesh is not None:
            self._comm = MeshComm(mesh)
            if self._comm.P != P:
                raise ValueError(f"P={P} partitions on a mesh whose shard "
                                 f"axis has {self._comm.P} ranks")
            if mesh.size() != dist.get_world_size():
                raise ValueError("the service's mesh must span the world")
            self._rows = slice(self._comm.p, self._comm.p + 1)
            self.device = self._comm.device
        else:
            self.device = resolve_device(device)
        self.mesh = mesh
        self.P = P
        self.cfg = cfg or default_config()
        self.order_kind = order_kind
        self.max_batch = max_batch
        self.validate = validate
        self.seed = seed
        self.serve = serve or ServeConfig()
        self._clock = clock or WallClock()
        self._queue: list[_Job] = []
        self._next_id = 0
        self._memo: OrderedDict[str, _Entry] = OrderedDict()
        self._memo_max = memo_graphs
        self._engines: list[_Engine] = []
        self._engine_seq = 0
        self._futures: OrderedDict[int, JobFuture] = OrderedDict()
        self._results: dict[int, dict] = {}
        self._n_solo = self._n_batch = self._n_lane = 0
        self._n_shed = self._n_deferred = self._n_failed = 0
        self._memo_hits = 0

    def _now(self) -> float:
        """The service clock: on a mesh, the first rank's reading."""
        t = self._clock.now()
        return t if self._comm is None else self._comm.root_value(t)

    @property
    def pending(self) -> int:
        """Jobs the service still owes a resolution: queued + running."""
        return len(self._queue) + sum(e.n_running for e in self._engines)

    def submit(self, g: Graph, *, marked: np.ndarray | None = None) -> int:
        """Enqueue one graph; returns the request id results key on.

        Continuous mode applies the queue-depth bound here: past
        ``max_queue`` the request is shed at once (its future raises
        ``ShedError``; the id is still valid for ``future``)."""
        if self.cfg.color.partial != (marked is not None):
            raise ValueError("marked= requires (and is required by) a "
                             "partial color config")
        job = _Job(self._next_id, g, marked, t_submit=self._now())
        self._next_id += 1
        if (self.serve.mode == "continuous"
                and len(self._queue) >= self.serve.max_queue):
            self._shed(job, f"queue depth {len(self._queue)} at bound "
                            f"max_queue={self.serve.max_queue}")
            return job.id
        self._queue.append(job)
        return job.id

    def submit_async(self, g: Graph, *,
                     marked: np.ndarray | None = None) -> JobFuture:
        """``submit`` + the request's future."""
        return self.future(self.submit(g, marked=marked))

    def future(self, job_id: int) -> JobFuture:
        """The ``JobFuture`` of a submitted request id."""
        if not 0 <= job_id < self._next_id:
            raise KeyError(f"unknown request {job_id}")
        fut = self._futures.get(job_id)
        if fut is None:
            fut = self._futures[job_id] = JobFuture(self, job_id)
            out = self._results.get(job_id)
            if out is not None:      # already completed before first lookup
                err = out.get("error")
                fut._resolve(out, JobError(job_id, err) if err else None)
        return fut

    def stats(self) -> dict:
        """Scheduler + program-cache counters (cache stats process-wide).

        ``solo``/``batch``/``lane`` count completions by route;
        ``n_shed``/``n_deferred``/``n_failed`` count admission-control
        rejections, jobs that waited at least one poll for a lane, and
        per-lane failures; ``queued``/``running`` are what ``pending``
        sums."""
        return dict(solo=self._n_solo, batch=self._n_batch,
                    lane=self._n_lane, n_shed=self._n_shed,
                    n_deferred=self._n_deferred, n_failed=self._n_failed,
                    queued=len(self._queue),
                    running=sum(e.n_running for e in self._engines),
                    engines=len(self._engines),
                    memo_hits=self._memo_hits, memo_size=len(self._memo),
                    signatures=len({e.signature
                                    for e in self._memo.values()}),
                    **program_cache_stats())

    def prewarm(self, samples) -> float:
        """Run each still-cold sample once per missing solo program — the
        pow2-padded member's (shared by every later same-signature
        request) and the sample's exact-dims one — so later requests take
        the solo route.  Returns the wall seconds spent."""
        t0 = time.perf_counter()
        for g in samples:
            e = self._entry(g)
            marked = (np.zeros(g.n, dtype=bool)
                      if self.cfg.color.partial else None)
            if not program_cache_contains(e.solo_sig):
                self._run_solo(_Job(0, g, marked), e, e.member, e.order)
            if not program_cache_contains(e.exact_sig):
                self._run_solo(_Job(0, g, marked), e, e.pg, e.exact_order)
        return time.perf_counter() - t0

    # --------------------------------------------------- continuous scheduler --

    def poll(self) -> dict[int, dict]:
        """One scheduler step; returns results completed during the call.

        Order: (1) admission pass over the FIFO queue — solo dispatch of
        a warm request, lane admission into a compatible engine (creating
        one under the ``max_engines`` cap), or shed/defer per the SLO;
        (2) every engine with running lanes advances one ``chunk_iters``
        step; (3) finished lanes drain to results and free up."""
        results: dict[int, dict] = {}
        now = self._now()
        progressed = False
        still: list[_Job] = []
        for job in self._queue:
            if self._admit_one(job, now, results) == "defer":
                still.append(job)
            else:
                progressed = True
        self._queue = still
        for eng in self._engines:
            if eng.n_running:
                done = eng.step()
                eng.drain(done, self._now(), results)
                progressed = True
        if self._queue and not progressed:
            raise RuntimeError(
                "scheduler stalled: every queued job deferred with no "
                "lane running (lanes/max_engines too small for the mix?)")
        return results

    def flush(self) -> dict[int, dict]:
        """Drain everything; returns every result since the last flush.

        Continuous mode polls until the queue and all lanes are empty;
        ``"flush"`` mode runs the batch-synchronous router's waves."""
        if self.serve.mode == "flush":
            return self._flush_waves()
        polls = 0
        while self.pending:
            self.poll()
            polls += 1
            if polls >= 1_000_000:
                raise RuntimeError("flush did not drain")
        out, self._results = self._results, {}
        return out

    def _admit_one(self, job: _Job, now: float, results: dict) -> str:
        """Admission decision for one queued request:
        ``"solo"`` | ``"lane"`` | ``"shed"`` | ``"defer"``."""
        e = self._entry(job.graph)
        cfg = resolve_pipeline_cfg(e.member, self.cfg)
        sc = self.serve
        if sc.solo_warm and (program_cache_contains(e.exact_sig)
                             or program_cache_contains(e.solo_sig)):
            r = self._solo_dispatch(job, e)
            out = dict(colors=r["colors"],
                       n_colors=(r["history"][-1]["n_colors_distinct"]
                                 if r["history"]
                                 else r["color"]["n_colors_distinct"]),
                       color=r["color"], history=r["history"],
                       n_iters_run=r["n_iters_run"], bucket=r["bucket"],
                       route="solo",
                       latency_s=self._now() - job.t_submit)
            err = None
            if self.validate:
                out["check"] = check_coloring(
                    job.graph, r["colors"],
                    distance=self.cfg.recolor.distance, marked=job.marked)
                if not out["check"]["valid"]:
                    err = (f"request {job.id}: invalid coloring "
                           f"({out['check']})")
            if err:
                out["error"] = err
                self._fail(job, out, err, results)
            else:
                self._complete(job, out, results)
                self._n_solo += 1
            return "solo"
        m = e.member
        nat = dict(n_local_max=m.n_local_max, max_ghost=m.max_ghost,
                   max_boundary=m.max_boundary, m_local_max=m.m_local_max,
                   maxd=m.maxd, maxd2=m.maxd2)
        fits = [g for g in self._engines if g.accepts(e, cfg)]
        # best fit: an exact-dims engine first, else a fresh tight engine
        # (a small member padded into an oversized engine makes every one
        # of its chunks pay the big dims); pad-up into the tightest
        # fitting engine only when the cap blocks a new one
        eng = next((g for g in fits if g.dims == nat), None)
        if eng is None:
            eng = self._new_engine(e, cfg)
        if eng is None and fits:
            eng = min(fits, key=lambda g: (np.prod(
                [float(v) for v in g.dims.values()]), g.eid))
        b = eng.free_lane() if eng is not None else None
        if b is not None:
            eng.admit(job, b, e, now)
            return "lane"
        est = eng.estimate_s() if eng is not None else 0.0
        if sc.slo_s is not None and (now - job.t_submit) + est > sc.slo_s:
            self._shed(job, f"admission control: queue age "
                            f"{now - job.t_submit:.3f}s + estimate "
                            f"{est:.3f}s exceeds SLO {sc.slo_s}s")
            return "shed"
        if not job.deferred:
            job.deferred = True
            self._n_deferred += 1
        return "defer"

    def _new_engine(self, e: _Entry, cfg: PipelineConfig) -> _Engine | None:
        """Create an engine for ``e``'s shape, evicting the LRU *idle*
        engine when at the cap; ``None`` when every engine is busy."""
        if len(self._engines) >= self.serve.max_engines:
            idle = [g for g in self._engines if g.n_running == 0]
            if not idle:
                return None
            self._engines.remove(min(idle, key=lambda g: g.last_used))
        eng = _Engine(self, e, cfg, self._engine_seq)
        self._engine_seq += 1
        self._engines.append(eng)
        return eng

    def _complete(self, job: _Job, out: dict, results: dict) -> None:
        results[job.id] = out
        self._results[job.id] = out
        self._resolve_future(job.id, out, None)

    def _fail(self, job: _Job, out: dict, err: str, results: dict) -> None:
        results[job.id] = out
        self._results[job.id] = out
        self._n_failed += 1
        self._resolve_future(job.id, out, JobError(job.id, err))

    def _shed(self, job: _Job, why: str) -> None:
        self._n_shed += 1
        self._resolve_future(job.id, None,
                             ShedError(job.id, f"request {job.id} shed: "
                                               f"{why}"))

    def _resolve_future(self, job_id: int, out, err) -> None:
        fut = self._futures.get(job_id)
        if fut is None:
            fut = self._futures[job_id] = JobFuture(self, job_id)
        fut._resolve(out, err)
        while len(self._futures) > 4096:
            oldest = next(iter(self._futures))
            if not self._futures[oldest].done():
                break
            del self._futures[oldest]

    # ------------------------------------------------------------ internals --

    @property
    def _halo(self) -> int:
        return 2 if self.cfg.recolor.distance == 2 else 1

    def _entry(self, g: Graph) -> _Entry:
        """Partition + bucket + signatures, memoized by graph content."""
        fp = _graph_fingerprint(g)
        e = self._memo.get(fp)
        if e is not None:
            self._memo.move_to_end(fp)
            self._memo_hits += 1
            return e
        pg = partition_graph(g, self.P, seed=self.seed, halo=self._halo)
        bucket = bucket_graphs([pg])[0]
        member = bucket.members[0]
        e = _Entry(pg=pg, bucket=bucket,
                   signature=bucket_signature(bucket, self.cfg,
                                              mesh=self.mesh),
                   solo_sig=plan_signature(member, self.cfg, mesh=self.mesh),
                   order=compute_order(member, self.order_kind),
                   exact_sig=plan_signature(pg, self.cfg, mesh=self.mesh),
                   exact_order=compute_order(pg, self.order_kind))
        self._memo[fp] = e
        while len(self._memo) > self._memo_max:
            self._memo.popitem(last=False)
        return e

    def _marked_blocks(self, pg, marked_g):
        """Global per-vertex mask -> the (P, n_local_max) block layout."""
        out = np.zeros((pg.P, pg.n_local_max), dtype=bool)
        for p in range(pg.P):
            nl, lo = int(pg.n_local[p]), int(pg.offs[p])
            out[p, :nl] = marked_g[lo:lo + nl]
        return out

    def _keys(self, jobs):
        """Request-id-folded per-graph keys: route-independent results."""
        ck = rng.key(self.cfg.color.seed)
        rk = rng.key(self.cfg.seed)
        return ([rng.fold_in(ck, j.id) for j in jobs],
                [rng.fold_in(rk, j.id) for j in jobs])

    def _solo_dispatch(self, job, e: _Entry) -> dict:
        """One request through ``pipeline_sim`` — the warm route.  Prefers
        the original dims' cached entry (no padding work; ``prewarm``
        makes it for sample graphs), else the pow2-padded member's, which
        fresh same-signature graphs share."""
        if program_cache_contains(e.exact_sig):
            tgt, order = e.pg, e.exact_order
        else:
            tgt, order = e.member, e.order
        return self._run_solo(job, e, tgt, order)

    def _run_solo(self, job, e: _Entry, tgt, order) -> dict:
        cks, rks = self._keys([job])
        marked = (self._marked_blocks(tgt, job.marked)
                  if self.cfg.color.partial else None)
        keys = dict(marked=marked, color_key=cks[0], recolor_key=rks[0])
        if self.mesh is None:
            view, res = pipeline_sim(tgt, order, self.cfg, device=self.device,
                                     **keys)
        else:
            view, res = pipeline_sharded(tgt, order, self.cfg, self.mesh,
                                         **keys)
        view = view.cpu().numpy()
        return dict(
            colors=e.pg.gather_global_colors(view[:, :e.pg.n_local_max]),
            color=res["color"], history=res["history"],
            n_iters_run=res["n_iters_run"], bucket=0)

    def _dispatch(self, jobs, entries=None, buckets=None):
        """One ``color_many`` call for ``jobs`` (a cold group)."""
        pgs = [e.pg for e in entries] if entries is not None else [
            partition_graph(j.graph, self.P, seed=self.seed, halo=self._halo)
            for j in jobs]
        if entries is not None and buckets is None:
            # reuse the memoized bucket whenever its indices line up: its
            # union plan and device arrays are cached on the instance
            buckets = [e.bucket if e.bucket.indices == (i,) else
                       dataclasses.replace(e.bucket, indices=(i,))
                       for i, e in enumerate(entries)]
        marked = None
        if self.cfg.color.partial:
            marked = [self._marked_blocks(pg, j.marked)
                      for pg, j in zip(pgs, jobs)]
        cks, rks = self._keys(jobs)
        # pad_batch: pow2 lane counts keep the batch signatures stable as
        # the queue depth fluctuates
        kw = dict(orders=self.order_kind, marked=marked, color_keys=cks,
                  recolor_keys=rks, buckets=buckets, pad_batch=True)
        if self.mesh is None:
            return color_many(pgs, self.cfg, device=self.device, **kw)
        return color_many_sharded(pgs, self.cfg, self.mesh, **kw)

    def _finish(self, job, r, latency, route, results):
        out = dict(colors=r["colors"],
                   n_colors=(r["history"][-1]["n_colors_distinct"]
                             if r["history"]
                             else r["color"]["n_colors_distinct"]),
                   history=r["history"], n_iters_run=r["n_iters_run"],
                   bucket=r["bucket"], route=route, latency_s=latency)
        if self.validate:
            out["check"] = check_coloring(
                job.graph, r["colors"],
                distance=self.cfg.recolor.distance, marked=job.marked)
            if not out["check"]["valid"]:
                raise RuntimeError(f"request {job.id}: invalid coloring "
                                   f"({out['check']})")
        results[job.id] = out
        self._resolve_future(job.id, out, None)

    def _flush_waves(self) -> dict[int, dict]:
        """Route and dispatch the queue in waves of ``max_batch``."""
        results: dict[int, dict] = {}
        while self._queue:
            jobs, self._queue = (self._queue[:self.max_batch],
                                 self._queue[self.max_batch:])
            pairs = [(j, self._entry(j.graph)) for j in jobs]

            def _warm(e):
                # solo_warm=False sends every request through a wave
                return self.serve.solo_warm and (
                    program_cache_contains(e.solo_sig)
                    or program_cache_contains(e.exact_sig))

            warm = [(j, e) for j, e in pairs if _warm(e)]
            cold = [(j, e) for j, e in pairs if not _warm(e)]
            # the cached route: each request now, on its own
            for j, e in warm:
                t0 = self._now()
                out = self._solo_dispatch(j, e)
                self._finish(j, out, self._now() - t0, "solo",
                             results)
                self._n_solo += 1
            # the rest grouped by solo signature: the group's padded dims
            # and union plan equal every member's own, so the same traffic
            # shape gives the same batch signature on every flush
            groups: OrderedDict = OrderedDict()
            for j, e in cold:
                groups.setdefault(e.signature, []).append((j, e))
            for sub in groups.values():
                bucket = bucket_graphs([e.pg for _, e in sub])[0]
                t0 = self._now()
                outs = self._dispatch([j for j, _ in sub],
                                      [e for _, e in sub], [bucket])
                lat = self._now() - t0
                for (j, _), r in zip(sub, outs):
                    self._finish(j, r, lat, "batch", results)
                    self._n_batch += 1
        return results


def _traffic(n_graphs: int, scale_lo: int, scale_hi: int, seed: int):
    """A synthetic request mix: the three RMAT classes at mixed scales."""
    gen = np.random.default_rng(seed)
    gens = (rmat.rmat_er, rmat.rmat_good, rmat.rmat_bad)
    return [gens[i % 3](int(gen.integers(scale_lo, scale_hi + 1)), 8,
                        seed=int(gen.integers(1 << 30)))
            for i in range(n_graphs)]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--graphs", type=int, default=16)
    ap.add_argument("--p", type=int, default=4)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--scale-min", type=int, default=6)
    ap.add_argument("--scale-max", type=int, default=8)
    ap.add_argument("--max-colors", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mode", choices=("continuous", "flush"),
                    default="continuous")
    ap.add_argument("--lanes", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device (default CUDA; 'cpu' runs the plain "
                         "kernels)")
    args = ap.parse_args(argv)

    graphs = _traffic(args.graphs, args.scale_min, args.scale_max, args.seed)
    svc = ColoringService(
        P=args.p, validate=True, device=args.device,
        cfg=default_config(max_colors=args.max_colors, n_iters=args.iters),
        serve=ServeConfig(mode=args.mode, lanes=args.lanes))
    ids = [svc.submit(g) for g in graphs]

    t0 = time.perf_counter()
    res = svc.flush()
    t_cold = time.perf_counter() - t0
    n_buckets = len({r["bucket"] for r in res.values()})
    # the one-lane entries of the shapes just seen, so later requests of
    # those shapes take the solo route
    t_pre = svc.prewarm(graphs)
    # fresh graphs of the same shapes
    for g in _traffic(args.graphs, args.scale_min, args.scale_max,
                      args.seed + 1):
        svc.submit(g)
    t0 = time.perf_counter()
    res2 = svc.flush()
    t_warm = time.perf_counter() - t0
    lats = sorted(r["latency_s"] for r in res2.values())
    st = svc.stats()
    hit_rate = st["hits"] / max(st["hits"] + st["misses"], 1)

    print(f"served {len(ids)} graphs over {n_buckets} "
          f"{'engines' if args.mode == 'continuous' else 'buckets'} at "
          f"P={args.p} on {svc.device}: cold {t_cold:.2f}s, prewarm "
          f"{t_pre:.2f}s, warm {t_warm:.3f}s "
          f"({len(ids) / max(t_warm, 1e-9):.1f} graphs/s)")
    print(f"routes solo={st['solo']} lane={st['lane']} batch={st['batch']} "
          f"shed={st['n_shed']} program-cache hit rate {hit_rate:.2f} "
          f"p50 {lats[len(lats) // 2] * 1e3:.1f}ms "
          f"p99 {lats[min(len(lats) - 1, int(len(lats) * 0.99))] * 1e3:.1f}ms")
    for i in ids[:8]:
        r = res[i]
        print(f"  req {i}: {r['n_colors']} colors after "
              f"{r['n_iters_run']} RC iters (bucket {r['bucket']}, "
              f"valid={r['check']['valid']})")


if __name__ == "__main__":
    main()
