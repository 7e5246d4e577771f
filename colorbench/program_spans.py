"""The program's own spans and counters, as the traced window recorded
them.

The port (``repro_torch.tracing``) opens spans named ``repro_torch.<name>``
while a profiler records, so they sit among the host operations of
``Trace.host``, on the clock of the device's intervals; its counters count
while the profiler records, which in a run is the traced window alone (one
run is one process).  Each function here returns None where there is
nothing to read: no trace, a program without the span, or one without
``repro_torch.tracing``.
"""
from __future__ import annotations

import numpy as np

PREFIX = "repro_torch."


def solves(run) -> int:
    """The traced window's solves (0 without a trace)."""
    if run.trace is None or "solve" not in run.trace.spans:
        return 0
    return len(run.trace.spans["solve"])


def spans(run, name: str, prefix: bool = False):
    """``(start, end)`` ns arrays of the program's spans ``repro_torch.<name>``
    in the traced window (with ``prefix``, every span whose name starts with
    it); None where there is none."""
    if not solves(run):
        return None
    lo, hi = run.trace.window
    host = run.trace.host.within(lo, hi)
    full = PREFIX + name
    idx = [i for i, n in enumerate(host.names)
           if (n.startswith(full) if prefix else n == full)]
    if not idx:
        return None
    return host.start[idx], host.end[idx]


def per_solve(run, total) -> float | None:
    """``total`` over the traced window's solves; None for a None total."""
    return None if total is None else total / solves(run)


def count_per_solve(run, name: str, prefix: bool = False) -> float | None:
    """How many spans ``repro_torch.<name>`` a solve opened."""
    iv = spans(run, name, prefix)
    return None if iv is None else per_solve(run, len(iv[0]))


def ms_per_solve(run, name: str, prefix: bool = False) -> float | None:
    """The summed duration of the spans ``repro_torch.<name>``, in ms a
    solve."""
    iv = spans(run, name, prefix)
    return None if iv is None else per_solve(
        run, float(np.sum(iv[1] - iv[0])) / 1e6)


def counter(run, name: str) -> int | None:
    """The program's counter ``name`` over the traced window; None without a
    trace or where the program has no such counter."""
    if not solves(run):
        return None
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    return tracing.counters().get(name)
