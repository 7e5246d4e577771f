"""The harness driven on the CPU at a tiny size, past its look for a card:
sound runs come out correct, and runs with the timed path broken
underneath come out not correct, once for each fault a cell can have."""
from __future__ import annotations

import io
import time

import pytest
import torch

from colorbench import harness
from repro_torch.core import pipeline, speculative

CELLS = ("tiny-rmat.quality", "tiny-rmat.speed", "tiny-grid.quality",
         "tiny-grid.speed")


def run(tiny_bench, workload, trace=False, seconds=0.3):
    manifest, bench = tiny_bench
    cell = harness.load_cell(manifest, bench, workload, trace)
    torch.set_num_threads(1)
    return harness.run_cell(cell, 2**31 + 11, seconds, trace,
                            torch.device("cpu"), time.perf_counter(),
                            err=io.StringIO())


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_is_correct(tiny_bench, workload, trace):
    res = run(tiny_bench, workload, trace)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    names = set(res["metrics"])
    if trace:
        assert {"partition_s", "to_device_s", "color_ms"} <= names
        assert "breakdown" not in res or res["breakdown"]["device_ops"] == []
    else:
        assert {"solve_ms", "colors", "setup_s"} <= names
    assert list(res)[-1] == "checks"


def _unchanged_coloring(real):
    """The speculative stage returns its state unchanged: no color."""
    def color_lanes(arrs, order, keys, cfg, *a, **k):
        view, stats = real(arrs, order, keys, cfg, *a, **k)
        return torch.zeros_like(view), stats
    return color_lanes


def _unchanged_recoloring(real):
    """The recoloring loop returns its state unchanged."""
    def recolor_loop(arrs, view, key, cfg):
        return view, [], 0
    return recolor_loop


def _half_the_shards(real):
    """Half of the shards are left out of the speculative coloring."""
    def color_lanes(arrs, order, keys, cfg, *a, **k):
        view, stats = real(arrs, order, keys, cfg, *a, **k)
        view = view.clone()
        view[view.shape[0] // 2:] = 0
        return view, stats
    return color_lanes


def _altered_answer(real):
    """One vertex's final color is altered where it is produced."""
    def recolor_loop(arrs, view, key, cfg):
        view, hist, n = real(arrs, view, key, cfg)
        view = view.clone()
        view[0, 0] += 1
        return view, hist, n
    return recolor_loop


class _NoExchange:
    """An exchange that moves nothing: ghosts keep stale colors."""

    def __init__(self, real):
        self.real = real

    def __getattr__(self, name):
        return getattr(self.real, name)

    def __call__(self, view, lanes=None, rounds=None):
        return view, [0] * len(lanes)


FAULTS = {
    "coloring_unchanged": [(speculative, "color_lanes", _unchanged_coloring)],
    "recoloring_unchanged": [(pipeline, "recolor_loop",
                              _unchanged_recoloring)],
    "half_the_shards": [(speculative, "color_lanes", _half_the_shards)],
    "no_exchange": [
        (mod, "make_exchange",
         lambda real: lambda *a, **k: _NoExchange(real(*a, **k)))
        for mod in (speculative, pipeline)],
    "altered_answer": [(pipeline, "recolor_loop", _altered_answer)],
}
# a fault that leaves nothing to break in a cell: without recoloring
# iterations the recoloring loop already returns its state unchanged
NOT_IN = {("recoloring_unchanged", "speed")}


@pytest.mark.parametrize("fault,workload", [
    (f, w) for f in sorted(FAULTS) for w in CELLS
    if (f, w.split(".")[1]) not in NOT_IN])
def test_fault_is_not_correct(tiny_bench, monkeypatch, fault, workload):
    for mod, name, wrap in FAULTS[fault]:
        monkeypatch.setattr(mod, name, wrap(getattr(mod, name)))
    res = run(tiny_bench, workload)
    assert not res["correct"], res["checks"]
    assert res["failed"] >= 1
