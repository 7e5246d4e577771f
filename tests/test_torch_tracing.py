"""The port's spans and counters (``repro_torch.tracing``) on the solve
path: under ``torch.profiler`` the spans agree with the program's own
stats, nest as the calls do, and the counters count what a plain run
recounts; without a profiler nothing is recorded, and the views are
bitwise the same either way."""
import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import repro_torch.core as T
from repro_torch import rng, tracing
from repro_torch.core import comm, pipeline, presets, speculative
from test_torch_threads import one_torch_thread  # noqa: F401

CASES = [(1, "sparse"), (1, "allgather"), (2, "sparse"), (2, "allgather")]


def _setup(distance, scheme, n_iters=3, patience=0):
    """A small solve like the benchmark's quality cells: (arrs, order,
    cfg)."""
    if distance == 1:
        g, P, halo, color = T.rmat.rmat_good(9, 8, seed=3), 8, 1, {}
    else:
        g, P, halo, color = T.rmat.grid3d(5, 5, 4), 4, 2, {"tile": 16}
    pg = T.partition_graph(g, P, halo=halo)
    cfg = presets.pipeline_config(presets.quality(superstep=32),
                                  n_iters=n_iters, patience=patience)
    cfg = dataclasses.replace(
        cfg,
        color=dataclasses.replace(cfg.color, distance=distance,
                                  scheme=scheme, **color),
        recolor=dataclasses.replace(cfg.recolor, distance=distance,
                                    scheme=scheme))
    order = T.compute_order(pg, T.ordering.INTERNAL_FIRST)
    arrs = T.to_device(pg, "cpu", sparse=cfg.needs_sparse_plan)
    return arrs, torch.as_tensor(order), cfg


def _solve(arrs, order, cfg):
    k = rng.key(11)
    return pipeline.color_then_recolor(arrs, order, k, rng.fold_in(k, 1),
                                       cfg)


def _spans(prof) -> list:
    """The profiler's ``repro_torch.*`` spans as ``(name, parent name)``,
    the parent the innermost enclosing span (None at the top)."""
    rows = sorted((e.start_ns(), -e.end_ns(), e.name()[len(tracing.PREFIX):])
                  for e in prof.profiler.kineto_results.events()
                  if e.name().startswith(tracing.PREFIX))
    out, stack = [], []
    for start, neg_end, name in rows:
        while stack and stack[-1][0] <= start:
            stack.pop()
        out.append((name, stack[-1][1] if stack else None))
        stack.append((-neg_end, name))
    return out


@dataclasses.dataclass
class Solve:
    cfg: object
    plain: tuple            # (view, color stats, history, n_iters_run)
    traced: tuple
    spans: list             # (name, parent)
    counters: dict
    losers: int             # recounted from the repairs of the plain run
    entries: int            # recounted from the exchanges of the plain run
    entries_due: int        # what a pull copies at each of those exchanges

    def count(self, name):
        return sum(n == name for n, _ in self.spans)


def _rewritten(ex, view, run):
    """``run(view)``'s result and how many ghost entries of ``ex`` it
    wrote: every ghost slot is marked first, and the ones left unwritten
    get their values back."""
    flat = view.view(-1)
    mark = flat.clone()
    flat[ex.dst] = -1
    out = run(view)
    written = out[0].view(-1)[ex.dst] != -1
    flat[ex.dst[~written]] = mark[ex.dst[~written]]
    return out, int(written.sum())


def _recount(monkeypatch, arrs, order, cfg):
    """The plain run, with the repairs' losers, the ghost entries each
    exchange wrote (a pull's copies or the recoloring loop's push) and
    the entries a pull copies at each of them, counted from outside the
    program."""
    losers, entries, due = [], [], []
    repair = speculative._detect_conflicts_frontier
    exchange = comm.FlatExchange.__call__
    push = comm.FlatExchange.push

    def counted_repair(*a, **k):
        out = repair(*a, **k)
        losers.append(int(out[1].sum()))
        return out

    def counted_exchange(self, view, lanes=None, rounds=None):
        out, n = _rewritten(self, view, lambda v: exchange(
            self, v, lanes=lanes, rounds=rounds))
        entries.append(n)
        due.append(n)
        return out

    def counted_push(self, view, *a, lanes=None, rounds=None, **k):
        # what the pull would have copied here, on a copy of the view
        due.append(_rewritten(self, view.clone(), lambda v: exchange(
            self, v, lanes=lanes, rounds=rounds))[1])
        out, n = _rewritten(self, view, lambda v: push(
            self, v, *a, lanes=lanes, rounds=rounds, **k))
        entries.append(n)
        return out

    with monkeypatch.context() as m:
        m.setattr(speculative, "_detect_conflicts_frontier", counted_repair)
        m.setattr(comm.FlatExchange, "__call__", counted_exchange)
        m.setattr(comm.FlatExchange, "push", counted_push)
        plain = _solve(arrs, order, cfg)
    return plain, sum(losers), sum(entries), sum(due)


_CACHE = {}


@pytest.fixture
def solve(monkeypatch):
    """``solve(distance, scheme, **kw)``: a case's ``Solve``, made once."""
    def get(distance, scheme, **kw):
        key = (distance, scheme, tuple(sorted(kw.items())))
        if key not in _CACHE:
            arrs, order, cfg = _setup(distance, scheme, **kw)
            plain, losers, entries, due = _recount(monkeypatch, arrs, order,
                                                   cfg)
            tracing.reset()
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                traced = _solve(arrs, order, cfg)
            _CACHE[key] = Solve(cfg, plain, traced, _spans(prof),
                                tracing.counters(), losers, entries, due)
        return _CACHE[key]
    return get


@pytest.mark.parametrize("distance,scheme", CASES)
def test_tracing_leaves_the_views_as_they_are(solve, distance, scheme):
    s = solve(distance, scheme)
    (va, ca, ha, na), (vb, cb, hb, nb) = s.plain, s.traced
    assert torch.equal(va, vb)
    assert (ca, ha, na) == (cb, hb, nb)


@pytest.mark.parametrize("distance,scheme", CASES)
def test_spans_agree_with_the_stats(solve, distance, scheme):
    s = solve(distance, scheme)
    _, cstats, hist, n_run = s.traced
    rounds = cstats["n_rounds"]
    assert n_run == s.cfg.n_iters and rounds >= 2
    assert s.count("color.round") == s.count("color.repair") == rounds
    assert s.count("color.frontier") == rounds + 1
    assert s.count("color.run") >= rounds
    assert s.count("recolor.iteration") == n_run
    assert s.count("recolor.schedule") == n_run
    assert s.count("recolor.run") >= n_run
    assert s.count("exchange") == (cstats["n_exchanges"]
                                   + sum(h["n_exchanges"] for h in hist))
    # the two exchanges' builds, and the recoloring one's fan-out for its
    # push, built at its first push
    assert s.count("exchange.build") == 3
    # the blocking reads: one a round and the trip that ends the loop, the
    # stats, one a schedule, the history, and two a sparse build
    assert s.count("read.round") == rounds + 1
    assert s.count("read.stats") == s.count("read.history") == 1
    assert s.count("read.schedule") == n_run
    assert s.count("read.exchange_build") == (4 if scheme == "sparse"
                                              else 0)
    assert {n for n, _ in s.spans if n.startswith("read.")} <= {
        "read.round", "read.stats", "read.schedule", "read.history",
        "read.exchange_build"}


@pytest.mark.parametrize("distance", [1, 2])
def test_spans_nest_as_the_calls(solve, distance):
    s = solve(distance, "sparse")
    parents = {"read.schedule": {"recolor.schedule"},
               "recolor.schedule": {"recolor.iteration"},
               "recolor.run": {"recolor.iteration"},
               "read.round": {"color.frontier"},
               "color.repair": {"color.round"},
               "color.run": {"color.round"},
               "exchange": {"color.round", "color.frontier",
                            "recolor.iteration"},
               "read.exchange_build": {"exchange.build"},
               "color.round": {None}, "color.frontier": {None},
               "recolor.iteration": {None},
               "exchange.build": {None, "recolor.iteration"}}
    for name, parent in s.spans:
        assert parent in parents.get(name, {None}), (name, parent)


@pytest.mark.parametrize("distance,scheme", CASES)
def test_counters_count_what_a_plain_run_recounts(solve, distance, scheme):
    s = solve(distance, scheme)
    assert s.losers > 0 and s.entries > 0
    assert s.counters == {"color.losers": s.losers,
                          "exchange.entries": s.entries,
                          "exchange.entries_due": s.entries_due}


def test_stopped_trip_is_one_more_iteration_span(solve):
    """A trip whose schedule read trips the adaptive stop builds its
    schedule and recolors nothing: one span more than the iterations."""
    s = solve(2, "sparse", n_iters=8, patience=1)
    n_run = s.traced[3]
    assert n_run < s.cfg.n_iters
    assert s.count("recolor.iteration") == n_run + 1
    assert s.count("read.schedule") == n_run + 1


def test_nothing_is_recorded_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    assert tracing.span("a") is tracing.span("b")
    tracing.reset()
    tracing.count("x", 3)
    _solve(*_setup(1, "sparse", n_iters=1))
    assert tracing.counters() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        assert tracing.span("a") is not tracing.span("a")
        tracing.count("x", 3)
        tracing.count("x", 2)
    assert tracing.counters() == {"x": 5}
    tracing.reset()
    assert tracing.counters() == {}
