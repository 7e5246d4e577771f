"""Shared pieces of the benchmark's CPU tests: the checkout and the port on
the import path, and a small benchmark folder of the same files with tiny
configurations, for driving the harness on the CPU."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_CONFIGS = {
    "tiny-rmat": {"generator": "rmat", "scale": 9, "edge_factor": 8,
                  "probs": [0.45, 0.15, 0.15, 0.25], "shards": 4, "halo": 1,
                  "distance": 1},
    "tiny-grid": {"generator": "grid3d", "nx": 8, "ny": 8, "nz": 8,
                  "shards": 4, "halo": 2, "distance": 2,
                  "color_args": {"tile": 16}},
}
# the harness's warm-up and kept solves, cut for the tiny runs
TINY_RUN = {"WARMUP_SOLVES": 1, "WARMUP_SECONDS": 0.0, "COLORS_SOLVES": 2,
            "CHECKED_SOLVES": 2}


def manifest_of(cells: dict) -> dict:
    """The repository's manifest with ``cells`` (name -> (config,
    traffic)) as its workloads and every metric applying to each."""
    m = json.loads((ROOT / "BENCHMARK.json").read_text())
    m["workloads"] = [{"name": name, "config": c, "traffic": t, "chips": 1,
                       "why": "test"} for name, (c, t) in cells.items()]
    for kind in ("end_to_end", "per_layer"):
        for entry in m[kind]:
            entry.pop("workloads", None)
    return m


@pytest.fixture
def tiny_bench(tmp_path, monkeypatch):
    """A benchmark folder with the repository's metric readers and traffic
    and the tiny configurations, and its manifest, with the harness cut to
    one warm-up solve and two kept solves; returns ``(manifest path,
    folder)``."""
    from colorbench import harness
    for name, value in TINY_RUN.items():
        monkeypatch.setattr(harness, name, value)
    bench = tmp_path / "bench"
    shutil.copytree(BENCH / "metrics", bench / "metrics")
    (bench / "configs").mkdir()
    (bench / "traffic").mkdir()
    for name, cfg in TINY_CONFIGS.items():
        (bench / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    for src in (BENCH / "traffic").glob("*.json"):
        t = json.loads(src.read_text())
        if t["n_iters"]:
            t["n_iters"] = 2
        (bench / "traffic" / src.name).write_text(json.dumps(t))
    cells = {f"{c}.{t}": (c, t) for c in TINY_CONFIGS
             for t in ("quality", "speed")}
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(manifest_of(cells)))
    return path, bench
