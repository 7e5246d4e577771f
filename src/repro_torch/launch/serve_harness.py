"""Deterministic fake-clock harness for the continuous-batching scheduler.

Drives a ``ColoringService`` (with an injected ``FakeClock``) through a
scripted arrival sequence: time is virtual (one tick per poll by default),
arrivals are submitted exactly when the scripted clock reaches them, and
the event loop interleaves submits with scheduler polls — so mid-flight
lane admission, SLO sheds and deferrals replay identically on every run.

    clock = FakeClock()
    svc = ColoringService(..., clock=clock, serve=ServeConfig(...))
    script = random_script(np.random.default_rng(0), graphs, n=20,
                           mean_gap=1.5)
    res = run_script(svc, script)
    # res.results / res.shed / res.failed / res.futures / res.polls

``run_script(..., poll_cost=None)`` runs the same loop on a hybrid clock:
arrivals stay scripted, and each poll advances the clock by its measured
wall seconds, so latencies follow the load (an open-loop benchmark).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.launch.serve_coloring import FakeClock, ShedError


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One scripted request: submit ``graph`` when the clock reaches ``t``."""
    t: float
    graph: object
    marked: object = None


@dataclasses.dataclass
class ScriptResult:
    """What a scripted run produced.

    ``results`` — every completed result (failures included, keyed by
    request id); ``futures`` — every request's ``JobFuture``; ``shed`` /
    ``failed`` — ids rejected by admission control / failed in their
    lane; ``submit_t`` — scripted submit time per id; ``polls`` — total
    scheduler polls the script took to drain; ``poll_log`` — per poll,
    ``(engine id, lane, request id)`` of every running lane just after
    it; ``poll_s`` — the wall seconds of each poll; ``done_t`` — per
    completed id, the clock just after the poll that completed it.
    """
    results: dict
    futures: dict
    shed: list
    failed: list
    submit_t: dict
    polls: int
    poll_log: list = dataclasses.field(default_factory=list)
    poll_s: list = dataclasses.field(default_factory=list)
    done_t: dict = dataclasses.field(default_factory=dict)


def run_script(svc, arrivals, *, poll_cost: float | None = 1.0,
               max_polls: int = 20000) -> ScriptResult:
    """Drive ``svc`` through ``arrivals`` on its injected ``FakeClock``.

    Event loop: submit every arrival whose time has come, run one
    ``svc.poll()`` (``svc.flush()`` in flush mode: a flush-when-idle
    server), advance the clock by ``poll_cost`` (virtual seconds
    per poll; ``None``: the poll's measured wall seconds), repeat; when
    the service is idle, jump the clock straight to the next arrival.
    With the default ``poll_cost=1`` arrival times are in poll ticks, so
    scripts express exact interleavings ("request 3 lands two chunks into
    request 1's run").
    """
    clock = svc._clock
    if not isinstance(clock, FakeClock):
        raise TypeError("inject a FakeClock into the service")
    pend = sorted(arrivals, key=lambda a: a.t)
    results: dict[int, dict] = {}
    futures: dict[int, object] = {}
    submit_t: dict[int, float] = {}
    poll_log: list = []
    poll_s: list = []
    done_t: dict[int, float] = {}
    step = svc.flush if svc.serve.mode == "flush" else svc.poll
    i = polls = 0
    while i < len(pend) or svc.pending:
        if not svc.pending and i < len(pend) and pend[i].t > clock.now():
            clock.advance(pend[i].t - clock.now())
        while i < len(pend) and pend[i].t <= clock.now():
            a = pend[i]
            jid = svc.submit(a.graph, marked=a.marked)
            futures[jid] = svc.future(jid)
            submit_t[jid] = clock.now()
            i += 1
        t0 = time.perf_counter()
        got = step()
        poll_s.append(time.perf_counter() - t0)
        clock.advance(poll_s[-1] if poll_cost is None else poll_cost)
        results.update(got)
        done_t.update(dict.fromkeys(got, clock.now()))
        poll_log.append([(e.eid, b, ln.job.id) for e in svc._engines
                         for b, ln in enumerate(e.lanes) if ln is not None])
        polls += 1
        if polls > max_polls:
            raise RuntimeError(f"script did not drain in {max_polls} polls "
                               f"({svc.pending} pending)")
    shed = [jid for jid, f in futures.items()
            if isinstance(f.exception(), ShedError)]
    failed = [jid for jid, f in futures.items()
              if f.exception() is not None
              and not isinstance(f.exception(), ShedError)]
    for jid, f in futures.items():
        if not f.done():
            raise RuntimeError(f"request {jid} unresolved after drain")
        if f.exception() is None and jid not in results:
            raise RuntimeError(f"request {jid} resolved without a result")
    return ScriptResult(results=results, futures=futures, shed=shed,
                        failed=failed, submit_t=submit_t, polls=polls,
                        poll_log=poll_log, poll_s=poll_s, done_t=done_t)


def random_script(rng: np.random.Generator, graphs, *, n: int,
                  mean_gap: float) -> list[Arrival]:
    """A seeded random arrival script: exponential gaps (Poisson process,
    mean ``mean_gap`` virtual seconds) over a uniform mix of ``graphs``."""
    ts = np.cumsum(rng.exponential(mean_gap, size=n))
    idx = rng.integers(0, len(graphs), size=n)
    return [Arrival(float(t), graphs[int(j)]) for t, j in zip(ts, idx)]


def mid_flight_admissions(poll_log) -> int:
    """Requests that entered an engine lane while another lane of the same
    engine was running (it ran the poll before, so it steps beside the
    new one), from ``ScriptResult.poll_log``."""
    n = 0
    for prev, cur in zip(poll_log, poll_log[1:]):
        before = {(eid, jid) for eid, _, jid in prev}
        busy = {eid for eid, _, _ in prev}
        n += sum((eid, jid) not in before and eid in busy
                 for eid, _, jid in cur)
    return n
