"""Reading a ``torch.profiler`` trace of the measured window.

The harness wraps the window, each solve and each stage of a solve in a
``record_function`` span named ``colorbench.<name>``; the profiler records
those spans, every host operation and every device operation in one clock.
``Trace`` keeps them as numpy arrays of nanoseconds, and the functions
below reduce them: the union of device intervals, its overlap with spans,
and the host operation under each idle gap of the device.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict

import numpy as np

SPAN_PREFIX = "colorbench."


@dataclasses.dataclass
class Intervals:
    """Named intervals in ns, sorted by start."""

    names: list
    start: np.ndarray
    end: np.ndarray

    @classmethod
    def of(cls, rows) -> "Intervals":
        rows = sorted(rows, key=lambda r: r[1])
        return cls([r[0] for r in rows],
                    np.array([r[1] for r in rows], dtype=np.int64),
                    np.array([r[2] for r in rows], dtype=np.int64))

    def __len__(self) -> int:
        return len(self.names)

    def within(self, lo: int, hi: int) -> "Intervals":
        """The intervals that start in ``[lo, hi)``."""
        keep = (self.start >= lo) & (self.start < hi)
        idx = np.nonzero(keep)[0]
        return Intervals([self.names[i] for i in idx], self.start[idx],
                         self.end[idx])


@dataclasses.dataclass
class Trace:
    spans: dict          # name (without the prefix) -> Intervals
    device: Intervals    # every operation on the device
    host: Intervals      # host operations of the thread that ran the window

    @property
    def window(self) -> tuple:
        w = self.spans["window"]
        return int(w.start[0]), int(w.end[0])

    def kernels(self) -> Intervals:
        """Device operations that are kernels (not copies or fills)."""
        idx = [i for i, n in enumerate(self.device.names)
               if not n.startswith(("Memcpy", "Memset"))]
        return Intervals([self.device.names[i] for i in idx],
                         self.device.start[idx], self.device.end[idx])


def from_profiler(prof) -> Trace:
    """The ``Trace`` of a stopped ``torch.profiler.profile``."""
    from torch.autograd import DeviceType
    spans, device, host = defaultdict(list), [], []
    window_thread = None
    events = prof.profiler.kineto_results.events()
    for ev in events:
        name = ev.name()
        row = (name, ev.start_ns(), ev.end_ns())
        if ev.device_type() == DeviceType.CPU:
            if name == SPAN_PREFIX + "window":
                window_thread = ev.start_thread_id()
            host.append((row, ev.start_thread_id()))
            if name.startswith(SPAN_PREFIX):
                spans[name[len(SPAN_PREFIX):]].append(row)
        elif not (name.startswith(SPAN_PREFIX) or ev.is_user_annotation()):
            device.append(row)
    return Trace(spans={k: Intervals.of(v) for k, v in spans.items()},
                 device=Intervals.of(device),
                 host=Intervals.of([r for r, t in host
                                    if t == window_thread]))


# --------------------------------------------------------- the reductions --

def union(iv: Intervals, lo: int | None = None, hi: int | None = None):
    """Disjoint sorted ``(start, end)`` arrays covering ``iv``, clipped to
    ``[lo, hi]`` where given."""
    s, e = iv.start, iv.end
    if lo is not None:
        s, e = np.maximum(s, lo), np.minimum(e, hi)
        keep = e > s
        s, e = s[keep], e[keep]
    if not len(s):
        return s, e
    order = np.argsort(s, kind="stable")
    s, e = s[order], np.maximum.accumulate(e[order])
    new = np.ones(len(s), dtype=bool)
    new[1:] = s[1:] > e[:-1]
    first = np.nonzero(new)[0]
    last = np.r_[first[1:] - 1, len(s) - 1]
    return s[first], e[last]


def covered_ns(us: np.ndarray, ue: np.ndarray, spans: Intervals) -> int:
    """How much of the disjoint intervals ``(us, ue)`` falls inside
    ``spans`` (which must not overlap one another)."""
    total = 0
    for a, b in zip(spans.start.tolist(), spans.end.tolist()):
        i = int(np.searchsorted(ue, a, side="right"))
        j = int(np.searchsorted(us, b, side="left"))
        if j > i:
            total += int((np.minimum(ue[i:j], b)
                          - np.maximum(us[i:j], a)).sum())
    return total


def busy_ns(trace: Trace, spans: Intervals) -> int:
    """Kernel time inside ``spans``: the union of the kernels' intervals
    in the window that falls inside them."""
    lo, hi = trace.window
    return covered_ns(*union(trace.kernels(), lo, hi), spans)


def idle_gaps(trace: Trace, top: int = 10) -> list:
    """The device's idle time in the window, summed by the host operation
    that ran at the middle of each gap (the innermost one), largest first:
    ``[[name, seconds], ...]``."""
    lo, hi = trace.window
    us, ue = union(trace.device, lo, hi)
    gs = np.r_[lo, ue]
    ge = np.r_[us, hi]
    keep = ge > gs
    gs, ge = gs[keep], ge[keep]
    mid = (gs + ge) // 2
    host = trace.host
    # the innermost host operation around each midpoint: the latest to
    # start before it, or failing that the latest of its enclosing ones
    parent = _parents(host)
    idx = np.searchsorted(host.start, mid, side="right") - 1
    for _ in range(64):
        miss = (idx >= 0) & (host.end[np.maximum(idx, 0)] < mid)
        if not miss.any():
            break
        idx = np.where(miss, parent[np.maximum(idx, 0)], idx)
    sums = defaultdict(int)
    for i, g in zip(idx.tolist(), (ge - gs).tolist()):
        sums[host.names[i] if i >= 0 else "(no host operation)"] += g
    ranked = sorted(sums.items(), key=lambda kv: -kv[1])[:top]
    return [[name, ns / 1e9] for name, ns in ranked]


def _parents(iv: Intervals) -> np.ndarray:
    """Index of each interval's innermost enclosing interval, -1 for none
    (``iv`` sorted by start, properly nested)."""
    parent = np.full(len(iv), -1, dtype=np.int64)
    stack: list = []
    ends = iv.end.tolist()
    for i, s in enumerate(iv.start.tolist()):
        while stack and ends[stack[-1]] <= s:
            stack.pop()
        if stack:
            parent[i] = stack[-1]
        stack.append(i)
    return parent


def device_ops(trace: Trace, top: int = 10) -> list:
    """Device time in the window by operation name, largest first:
    ``[[name, seconds], ...]``."""
    lo, hi = trace.window
    inside = trace.device.within(lo, hi)
    sums = defaultdict(int)
    for name, d in zip(inside.names, (inside.end - inside.start).tolist()):
        sums[name] += d
    ranked = sorted(sums.items(), key=lambda kv: -kv[1])[:top]
    return [[name, ns / 1e9] for name, ns in ranked]
