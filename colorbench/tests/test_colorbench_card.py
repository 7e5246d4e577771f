"""The command on a card, and without one.  The card test is marked
``cuda`` and decides inside itself whether a card is present; run it on
the card with ``python -m pytest colorbench/tests -m cuda``."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

from conftest import ROOT

FIRST = json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"][0]
COMMAND = [sys.executable, "colorbench/run.py", "--workload", FIRST["name"],
           "--seed", str(2**31 + 99), "--seconds", "3", "--trace", "0"]


def test_the_command_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(COMMAND, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


@pytest.mark.cuda
def test_the_command_runs_a_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(COMMAND, cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert {"solve_ms", "colors", "setup_s"} <= set(res["metrics"])
