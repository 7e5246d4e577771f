"""Spans and counters of the solve path, on the profiler's clock.

Tracing is on exactly while a ``torch.profiler.profile`` records: there is
no switch of its own.  ``span(name)`` then records a range named
``repro_torch.<name>``, so the spans sit in the profiler's timeline beside
the host operations and the device's kernels, nested as the calls nest on
the calling thread; ``count(name, n)`` adds to a process-wide counter.
With no profiler recording, ``span`` returns one shared null context and
``count`` does nothing: the cost is one check of the profiler's state.

    with torch.profiler.profile(activities=[...]) as prof:
        pipeline.color_then_recolor(...)
    # prof's events: repro_torch.color.round, repro_torch.exchange, ...
    tracing.counters()   # {"color.losers": ..., "exchange.entries": ...}

Spans: ``color.frontier`` (a round's compaction and read), ``color.round``,
``color.run``, ``color.repair``, ``recolor.iteration``,
``recolor.schedule``, ``recolor.run``, ``exchange``, ``exchange.build``
and ``read.<site>``, each blocking device-to-host read.  Counters:
``color.losers`` (vertices the repairs uncolored), ``exchange.entries``
(ghost entries the exchanges wrote or, on a mesh, sent) and
``exchange.entries_due`` (the entries of the lanes and rounds each exchange
was due to refresh: what a pull copies; the recoloring loop's pushes write
each recolored vertex's copies once an iteration, counted once an
iteration).
"""
from __future__ import annotations

import contextlib

import torch

PREFIX = "repro_torch."

# the profiler's lightweight form of record_function: a tenth of its cost
# a span while recording, which keeps the traced window close to the
# untraced one
_RECORD = torch._C._profiler._RecordFunctionFast
_NULL = contextlib.nullcontext()
_counts: dict = {}


def span(name: str):
    """A context that records ``repro_torch.<name>`` while a profiler
    records, else the shared null context."""
    if torch.autograd._profiler_enabled():
        return _RECORD(PREFIX + name)
    return _NULL


def count(name: str, n) -> None:
    """Add ``n`` to the counter ``name`` while a profiler records: an int,
    or a device scalar, which is read with the counters, so that counting
    adds no read to the recorded window."""
    if torch.autograd._profiler_enabled():
        _counts.setdefault(name, []).append(n)


def counters() -> dict:
    """The counters, as ints (this reads their device scalars)."""
    return {k: sum(int(n) for n in v) for k, v in _counts.items()}


def reset() -> None:
    """Zero every counter."""
    _counts.clear()
