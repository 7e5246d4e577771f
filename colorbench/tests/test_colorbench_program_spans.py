"""The metrics that read the program's own spans and counters
(``colorbench/program_spans.py``): present and finite in a traced run of
the tiny cells, absent untraced, and absent, without an error, where the
program has no such span or counter."""
from __future__ import annotations

import contextlib
import io
import math
import sys
import time

import pytest
import torch

import repro_torch
from colorbench import harness
from repro_torch import tracing

METRICS = ("color.rounds_per_solve", "color.losers_pct",
           "recolor.schedule_ms", "exchange.ms", "exchange.entries_per_solve",
           "host.reads_per_solve", "host.read_wait_ms")
CELLS = ("tiny-rmat.quality", "tiny-grid.quality")


@pytest.fixture(autouse=True)
def fresh_counters():
    """The counters are the process's: each run here starts them at 0."""
    tracing.reset()
    yield
    tracing.reset()


def run(tiny_bench, workload, trace):
    manifest, bench = tiny_bench
    cell = harness.load_cell(manifest, bench, workload, trace)
    torch.set_num_threads(1)
    return harness.run_cell(cell, 2**31 + 23, 0.3, trace,
                            torch.device("cpu"), time.perf_counter(),
                            err=io.StringIO())


@pytest.mark.parametrize("workload", CELLS)
def test_traced_run_reports_the_program_metrics(tiny_bench, workload):
    res = run(tiny_bench, workload, True)
    assert res["correct"], res["checks"]
    got = {m: res["metrics"][m]["value"] for m in METRICS}
    assert all(math.isfinite(v) and v >= 0 for v in got.values()), got
    assert got["color.rounds_per_solve"] >= 1
    assert 0 < got["color.losers_pct"] < 100
    assert got["exchange.entries_per_solve"] > 0
    # a round's read and the loop's last, the stats, a schedule each
    # iteration (2 in the tiny traffic), the history
    assert got["host.reads_per_solve"] >= got["color.rounds_per_solve"] + 5


@pytest.mark.parametrize("workload", CELLS)
def test_untraced_run_reports_none_of_them(tiny_bench, workload):
    res = run(tiny_bench, workload, False)
    assert res["correct"], res["checks"]
    assert not set(METRICS) & set(res["metrics"])


def test_a_program_without_spans_or_counters_reports_none(tiny_bench,
                                                          monkeypatch):
    """As the parent of the change that added them: the spans open nothing
    and ``repro_torch.tracing`` cannot be imported by the readers."""
    monkeypatch.setattr(tracing, "span",
                        lambda name: contextlib.nullcontext())
    monkeypatch.delattr(repro_torch, "tracing")
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    res = run(tiny_bench, CELLS[0], True)
    assert res["correct"], res["checks"]
    assert not set(METRICS) & set(res["metrics"])
    assert "color_ms" in res["metrics"]
