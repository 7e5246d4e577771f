"""The collective audit: the port's entry points run on a world, with a
recorder around every ``torch.distributed`` call ``core/comm.py`` makes.

The counterpart of the reference's ``trace_audit.py`` (its layer 2).
Where the AST rules reason about source, this layer runs the sharded
entry points on a ``torch.distributed`` world (gloo ranks on the CPU, or
NCCL on cards) and asserts on the calls the ranks actually issue:

(a) **same sequence on every rank** — per process group, every member
    issues the same sequence of collectives (op, dtype, shape, reduction,
    root): ``pipeline_sharded``, ``recolor_sharded``,
    ``color_many_sharded`` with lanes of different graphs, and the
    service's mesh route, under both exchange schemes.  Point-to-point
    rounds (``batch_isend_irecv``) are compared by count, and every send
    must have its peer's receive of the same size in the same round;
(b) **scheme resolution** — ``scheme="auto"`` records exactly the
    sequence of the scheme it resolves to;
(c) **one program build per PlanSignature** — a family of three or more
    signatures run twice builds one program-cache entry per signature
    (``core.program_cache_stats()``).

The reference's third check, "no host callbacks inside the fused loop
bodies", has no torch meaning: the port fuses no loop into a device
program; its loops are host Python by design, and their host reads are
what the AST rules judge.

Only the audit wraps ``torch.distributed`` (``CollectiveRecorder`` patches
the module's functions for the duration of a ``with`` block and restores
them); no hook enters the main path.  ``rank_case`` is the rank side
(module-level: a world of spawned processes can run it),
``sequence_failures`` and ``judge`` the comparisons, ``run_audit`` the
CLI's worlds of gloo ranks.
"""
from __future__ import annotations

import dataclasses
import multiprocessing
import queue
import tempfile
import traceback

import numpy as np
import torch
import torch.distributed as dist

#: the ``torch.distributed`` calls ``core/comm.py`` makes
WRAPPED = ("all_reduce", "all_gather", "all_gather_object", "broadcast",
           "batch_isend_irecv")


def _ranks(group) -> tuple:
    if group is None:
        return tuple(range(dist.get_world_size()))
    return tuple(dist.get_process_group_ranks(group))


class CollectiveRecorder:
    """Records every call of ``WRAPPED`` made inside the ``with`` block:
    ``calls`` holds ``(op, group ranks, detail)`` tuples in issue order."""

    def __init__(self):
        self.calls: list[tuple] = []
        self._saved: dict = {}

    def _wrap(self, name: str, fn):
        def wrapper(*args, **kwargs):
            self.calls.append(self._describe(name, args, kwargs))
            return fn(*args, **kwargs)
        return wrapper

    def _describe(self, name: str, args: tuple, kwargs: dict) -> tuple:
        if name == "batch_isend_irecv":
            ops = args[0] if args else kwargs["p2p_op_list"]
            group = ops[0].group if ops else None
            moves = tuple(("send" if op.op is self._saved["isend"] else
                           "recv", int(op.peer), str(op.tensor.dtype),
                           int(op.tensor.numel())) for op in ops)
            return (name, _ranks(group), moves)
        group = kwargs.get("group")
        if name == "all_reduce":
            t = args[0]
            op = kwargs.get("op", args[1] if len(args) > 1 else None)
            return (name, _ranks(group), (str(t.dtype), tuple(t.shape),
                                          str(op)))
        if name == "all_gather":
            outs, t = args[0], args[1]
            return (name, _ranks(group), (str(t.dtype), tuple(t.shape),
                                          len(outs)))
        if name == "all_gather_object":
            return (name, _ranks(group), (len(args[0]),))
        t = args[0]
        src = kwargs.get("src", args[1] if len(args) > 1 else None)
        return (name, _ranks(group), (str(t.dtype), tuple(t.shape), src))

    def __enter__(self):
        self._saved = {name: getattr(dist, name) for name in WRAPPED}
        self._saved["isend"] = dist.isend
        for name in WRAPPED:
            setattr(dist, name, self._wrap(name, self._saved[name]))
        return self

    def __exit__(self, *exc):
        for name in WRAPPED:
            setattr(dist, name, self._saved[name])
        return False

    def counts(self) -> dict:
        return call_counts(self.calls)


@dataclasses.dataclass
class Audit:
    """Outcome of one audit: passed checks and readable failures."""

    checks: list = dataclasses.field(default_factory=list)    # (name, detail)
    failures: list = dataclasses.field(default_factory=list)  # str

    @property
    def ok(self) -> bool:
        return not self.failures

    def record(self, name: str, ok: bool, detail: str) -> None:
        (self.checks.append((name, detail)) if ok
         else self.failures.append(f"{name}: {detail}"))

    def summary_lines(self) -> list:
        lines = [f"collective-audit: {len(self.checks)} check(s) passed, "
                 f"{len(self.failures)} failure(s)"]
        lines += [f"  ok   {name}: {detail}" for name, detail in self.checks]
        lines += [f"  FAIL {msg}" for msg in self.failures]
        return lines


# ------------------------------------------------------------ comparisons --

def sequence_failures(calls_by_rank: dict) -> list[str]:
    """Check (a) on one run: ``calls_by_rank`` maps a global rank to its
    recorded calls.  Per process group, every member's sequence must be
    the same (point-to-point rounds by count), and every send must meet
    its peer's receive of the same dtype and size in the same round."""
    out = []
    groups = {g for calls in calls_by_rank.values() for _, g, _ in calls}
    for g in sorted(groups):
        seqs, rounds = {}, {}
        for r in g:
            mine = [c for c in calls_by_rank.get(r, []) if c[1] == g]
            seqs[r] = [(op,) if op == "batch_isend_irecv" else (op, detail)
                       for op, _, detail in mine]
            rounds[r] = [detail for op, _, detail in mine
                         if op == "batch_isend_irecv"]
        first = seqs[g[0]]
        for r in g[1:]:
            if seqs[r] != first:
                k = next((i for i, (a, b) in enumerate(zip(first, seqs[r]))
                          if a != b), min(len(first), len(seqs[r])))
                out.append(f"group {g}: rank {r}'s sequence differs from rank "
                           f"{g[0]}'s at call {k} ({len(seqs[r])} vs "
                           f"{len(first)} calls: {seqs[r][k:k + 1]} vs "
                           f"{first[k:k + 1]})")
        for r in g:
            for k, moves in enumerate(rounds[r]):
                for kind, peer, dtype, n in moves:
                    if kind != "send":
                        continue
                    theirs = rounds.get(peer, [])
                    want = ("recv", r, dtype, n)
                    if k >= len(theirs) or want not in theirs[k]:
                        out.append(f"group {g}: rank {r}'s send of {n} "
                                   f"{dtype} to rank {peer} in round {k} "
                                   f"has no matching receive")
    return out


def call_counts(calls: list) -> dict:
    """Recorded calls by op."""
    out: dict = {}
    for name, _, _ in calls:
        out[name] = out.get(name, 0) + 1
    return out


def count_line(calls: list) -> str:
    return ", ".join(f"{k} {v}" for k, v in
                     sorted(call_counts(calls).items())) or "none"


# --------------------------------------------------------------- rank side --

def _graph(spec):
    from repro_torch.core import rmat
    name, args, seed = spec
    return getattr(rmat, name)(*args, **({} if seed is None else
                                         dict(seed=seed)))


def _pipeline_cfg(scheme: str, n_iters: int = 3, patience: int = 0):
    import repro_torch.core as T
    return T.PipelineConfig(
        color=T.ColorConfig(max_colors=64, superstep=16, max_rounds=8,
                            selection="random_x", random_x=3, scheme=scheme),
        recolor=T.RecolorConfig(max_colors=64, chunk=16, scheme=scheme),
        n_iters=n_iters, patience=patience)


def _recorded(fn):
    with CollectiveRecorder() as rec:
        out = fn()
    return rec.calls, out


def rank_case(case: dict, mesh_spec: tuple) -> dict:
    """Run one audit case on this rank of an initialised world and return
    ``{"calls": …, plus case-specific facts}``.

    ``case["kind"]``: ``"pipeline"`` (``pipeline_sharded`` of
    ``case["graph"]`` at ``case["scheme"]``), ``"recolor"`` (one
    ``recolor_sharded`` RAND iteration of its coloring), ``"many"``
    (``color_many_sharded`` of ``case["graphs"]``), ``"serve"`` (a
    ``FakeClock`` script through ``ColoringService(mesh=)``) or ``"cache"``
    (``pipeline_sharded`` of a graph family, twice)."""
    import repro_torch.core as T
    from repro_torch.launch.mesh import MeshSpec
    spec = MeshSpec(*mesh_spec)
    mesh = spec.build("cpu")
    P = dict(zip(spec.axes, spec.shape))["workers"]
    kind = case["kind"]
    if kind == "pipeline":
        pg = T.partition_graph(_graph(case["graph"]), P)
        order = T.compute_order(pg, "internal_first")
        cfg = _pipeline_cfg(case["scheme"])
        calls, (_, res) = _recorded(
            lambda: T.pipeline_sharded(pg, order, cfg, mesh))
        return dict(calls=calls, resolved=T.resolve_scheme(
            case["scheme"], pg), rounds=res["color"]["n_rounds"])
    if kind == "recolor":
        pg = T.partition_graph(_graph(case["graph"]), P)
        order = T.compute_order(pg, "internal_first")
        cfg = _pipeline_cfg(case["scheme"])
        view, _ = T.color_graph_sharded(pg, order, cfg.color, mesh)
        key = torch.tensor([0, 7], dtype=torch.int64)
        calls, _ = _recorded(lambda: T.recolor_sharded(
            pg, view, "rand", cfg.recolor, mesh, key=key))
        return dict(calls=calls)
    if kind == "many":
        pgs = [T.partition_graph(_graph(g), P) for g in case["graphs"]]
        cfg = _pipeline_cfg(case["scheme"], n_iters=4, patience=1)
        buckets = None
        if case.get("one_bucket"):     # every graph in one padded bucket
            dims = ("n_local_max", "max_ghost", "max_boundary",
                    "m_local_max", "maxd")
            wide = {d: max(getattr(pg, d) for pg in pgs) for d in dims}
            pgs = [T.pad_partition(pg, **wide) for pg in pgs]
            buckets = [T.GraphBucket(indices=tuple(range(len(pgs))),
                                     members=tuple(pgs))]
        calls, out = _recorded(lambda: T.color_many_sharded(
            pgs, cfg, mesh, buckets=buckets))
        return dict(calls=calls,
                    rounds=[r["color"]["n_rounds"] for r in out],
                    iters=[r["n_iters_run"] for r in out],
                    buckets=len({r["bucket"] for r in out}))
    if kind == "serve":
        from repro_torch.launch import serve_coloring as S
        from repro_torch.launch import serve_harness as H
        T.program_cache_clear()
        svc = S.ColoringService(
            P=P, cfg=S.default_config(max_colors=64, n_iters=4),
            validate=False, device="cpu", mesh=mesh, clock=S.FakeClock(),
            serve=S.ServeConfig(**case["serve"]))
        graphs = [_graph(g) for g in case["graphs"]]
        script = [H.Arrival(float(t), graphs[i]) for t, i in
                  enumerate(case["arrivals"])]
        calls, out = _recorded(lambda: H.run_script(svc, script))
        return dict(calls=calls, results=len(out.results),
                    shed=len(out.shed), failed=len(out.failed))
    if kind == "cache":
        T.program_cache_clear()
        cfg = _pipeline_cfg(case["scheme"])
        sigs = set()
        calls = []
        for _ in range(2):
            for g in case["graphs"]:
                pg = T.partition_graph(_graph(g), P)
                sigs.add(T.plan_signature(pg, cfg, mesh=mesh))
                order = T.compute_order(pg, "internal_first")
                got, _ = _recorded(
                    lambda: T.pipeline_sharded(pg, order, cfg, mesh))
                calls += got
        return dict(calls=calls, n_sigs=len(sigs),
                    stats=T.program_cache_stats())
    raise ValueError(f"unknown audit case {kind!r}")


# ------------------------------------------------------------- the audit --

#: the cases of ``run_audit``: a name, the world's mesh spec, the case
WORLD2 = ((2,), ("workers",))
WORLD2X2 = ((2, 2), ("batch", "workers"))
GRAPH = ("rmat_er", (8, 8), 1)
# three shapes (three plan signatures); in one padded bucket their lanes
# finish the coloring at different rounds and stop recoloring apart
GRAPHS = [("rmat_er", (7, 8), 1), ("rmat_bad", (7, 8), 2),
          ("grid2d", (16, 16, 9), None)]


def audit_cases() -> list[tuple]:
    """``(name, mesh spec, case)`` for every check of (a)–(c)."""
    out = []
    for scheme in ("sparse", "allgather", "auto"):
        out.append((f"pipeline/{scheme}", WORLD2,
                    dict(kind="pipeline", graph=GRAPH, scheme=scheme)))
    for scheme in ("sparse", "allgather"):
        out.append((f"recolor/{scheme}", WORLD2,
                    dict(kind="recolor", graph=GRAPH, scheme=scheme)))
        for name, spec in (("2", WORLD2), ("2x2", WORLD2X2)):
            out.append((f"many{name}/{scheme}", spec,
                        dict(kind="many", graphs=GRAPHS, scheme=scheme,
                             one_bucket=True)))
    out.append(("serve2x2", WORLD2X2,
                dict(kind="serve", graphs=GRAPHS[:2], arrivals=[0, 1, 0],
                     serve=dict(lanes=2, chunk_iters=1, solo_warm=False))))
    out.append(("cache", WORLD2, dict(kind="cache", graphs=GRAPHS,
                                      scheme="sparse")))
    return out


def judge(audit: Audit, name: str, outs: list) -> None:
    """Fold one case's per-rank outputs into ``audit``."""
    calls = {r: o["calls"] for r, o in enumerate(outs)}
    bad = sequence_failures(calls)
    audit.record("same-sequence", not bad,
                 f"{name}: " + ("; ".join(bad[:3]) if bad else
                                f"{len(outs)} ranks, {count_line(calls[0])}"))
    if name.startswith("cache"):
        o = outs[0]
        ok = all(x["stats"]["traces"] == x["n_sigs"] >= 3 for x in outs)
        audit.record("one-build-per-signature", ok,
                     f"{o['n_sigs']} signatures run twice: "
                     f"{o['stats']['traces']} build(s), hits "
                     f"{o['stats']['hits']}, misses {o['stats']['misses']}")


def judge_auto(audit: Audit, runs: dict) -> None:
    """(b): ``pipeline/auto`` against the scheme it resolved to."""
    auto = runs["pipeline/auto"]
    resolved = auto[0]["resolved"]
    same = all(a["calls"] == b["calls"] for a, b in
               zip(auto, runs[f"pipeline/{resolved}"]))
    audit.record("auto-resolves-identically", same,
                 f"pipeline: auto records the {resolved} sequence"
                 + ("" if same else " FAILED"))


def run_audit(timeout: float = 300.0) -> Audit:
    """Run every case on worlds of gloo ranks on this machine's CPU."""
    audit = Audit()
    runs = {}
    by_spec: dict = {}
    for name, spec, case in audit_cases():
        by_spec.setdefault(spec, []).append((name, case))
    for spec, cases in by_spec.items():
        n = int(np.prod(spec[0]))
        outs = run_world(n, _cases_on_rank, (cases, spec), timeout)
        for i, (name, _) in enumerate(cases):
            runs[name] = [o[i] for o in outs]
            judge(audit, name, runs[name])
    judge_auto(audit, runs)
    return audit


def _cases_on_rank(cases: list, spec: tuple) -> list:
    return [rank_case(case, spec) for _, case in cases]


def run_world(n: int, fn, args: tuple, timeout: float) -> list:
    """``fn(*args)`` on every rank of a new world of ``n`` gloo processes
    (a ``file://`` store in a temporary directory: no network); returns
    the ranks' results in rank order, or raises with the ranks' errors."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        out = ctx.Queue()
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, n, f"file://{tmp}/store", fn, args,
                                   out)) for r in range(n)]
        for p in procs:
            p.start()
        got, errors = {}, []
        try:
            for _ in range(n):
                rank, ok, val = out.get(timeout=timeout)
                (got.__setitem__(rank, val) if ok else
                 errors.append(f"rank {rank}:\n{val}"))
        except queue.Empty:
            errors.append(f"{n - len(got) - len(errors)} ranks gave no "
                          f"result in {timeout} s")
        finally:
            for p in procs:
                p.join(timeout=10)
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=10)
    if errors:
        raise RuntimeError("\n".join(errors))
    return [got[r] for r in range(n)]


def _rank_main(rank: int, n: int, init: str, fn, args: tuple, out) -> None:
    from repro_torch.launch.mesh import init_world
    torch.set_num_threads(1)
    init_world("gloo", init, rank=rank, world_size=n, timeout_s=120)
    try:
        out.put((rank, True, fn(*args)))
    except Exception:
        out.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()
