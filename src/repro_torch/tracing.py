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
``color.losers`` (vertices the repairs uncolored) and ``exchange.entries``
(ghost entries the exchanges copied or, on a mesh, sent).
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


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name`` while a profiler records."""
    if torch.autograd._profiler_enabled():
        _counts[name] = _counts.get(name, 0) + int(n)


def counters() -> dict:
    """A copy of the counters."""
    return dict(_counts)


def reset() -> None:
    """Zero every counter."""
    _counts.clear()
