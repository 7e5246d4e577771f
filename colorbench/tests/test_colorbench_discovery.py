"""A configuration, a traffic mix and a metric are added as files found by
name: the harness runs them with no edit to its code."""
from __future__ import annotations

import json
import time

import torch

from colorbench import harness


def test_added_files_are_found_and_run(tiny_bench):
    manifest, bench = tiny_bench
    (bench / "configs" / "added-grid.json").write_text(json.dumps(
        {"generator": "grid3d", "nx": 6, "ny": 5, "nz": 4, "shards": 2,
         "halo": 1, "distance": 1}))
    traffic = json.loads((bench / "traffic" / "quality.json").read_text())
    traffic["n_iters"] = 1
    (bench / "traffic" / "added-mix.json").write_text(json.dumps(traffic))
    (bench / "metrics" / "added_metric.py").write_text(
        "def read(run):\n    return run.n\n")
    m = json.loads(manifest.read_text())
    m["workloads"].append({"name": "added", "config": "added-grid",
                           "traffic": "added-mix", "chips": 1, "why": "t"})
    m["end_to_end"].append({"name": "added_metric", "unit": "vertices",
                            "better": "lower", "bound": 0.01,
                            "source": "host_clock",
                            "workloads": ["added"]})
    manifest.write_text(json.dumps(m))
    cell = harness.load_cell(manifest, bench, "added", False)
    res = harness.run_cell(cell, 4, 0.2, False, torch.device("cpu"),
                           time.perf_counter())
    assert res["correct"], res["checks"]
    assert res["metrics"]["added_metric"] == {"value": 120.0,
                                              "unit": "vertices"}
    # a metric that names its cells stays out of the others
    other = harness.load_cell(manifest, bench, "tiny-rmat.quality", False)
    assert "added_metric" not in {x["name"] for x in other.metrics}
