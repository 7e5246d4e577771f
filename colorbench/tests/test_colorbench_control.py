"""The control of the check (the reference in the program's place with
its conflict repair left out) comes out not correct at a size a test run
holds, on three seeds, in every tiny configuration."""
from __future__ import annotations

import json

import pytest
import torch

from colorbench import harness
from colorbench.control import control_numbers
from conftest import BENCH, TINY_CONFIGS


@pytest.mark.parametrize("config", sorted(TINY_CONFIGS))
@pytest.mark.parametrize("seed", [1, 2**31 + 5, 7])
def test_control_is_not_correct(config, seed):
    traffic = json.loads((BENCH / "traffic" / "quality.json").read_text())
    got = control_numbers(TINY_CONFIGS[config], traffic, seed,
                          torch.device("cpu"))
    assert set(got) == set(harness.LIMITS)
    assert any(v > harness.LIMITS[k] for k, v in got.items()), got
    assert got["color.conflicts"] > 0
