"""The sequence-parallel residual (``cfg.seq_parallel_acts``, Megatron-SP)
on gloo worlds of CPU ranks: in train mode the residual stream between a
layer's regions is each ``model`` rank's block of the sequence, gathered
where a region enters and reduce-scattered where it leaves
(``parallel.shard.enter_region`` / ``leave_region``).  The reference pins
the same carry at ``("batch", "act_seq", None)``; its one-device step,
run live with the same override, computes the same function, so the
split step is held to it as ``tests/test_torch_tp.py`` holds the compute
split, at that file's tolerances: one train step's loss, gradient norm and
every leaf's gradient, the parameters and AdamW's m and v after two
steps, the prefill's logits (``whisper-small``'s encoder runs its stack in
train mode in prefill too, so its output is gathered whole before the
decoder's cross-attention) and the greedy tokens.

Architectures: ``qwen3-0.6b`` on ``(1, 2)`` and ``(2, 2)`` and
``minicpm3-4b`` (MLA: its latents run whole on every rank) on ``(1, 2)``
here; ``moonshot-v1-16b-a3b`` and ``whisper-small`` in
``tests/test_torch_seq_parallel_more.py``, the sub-quadratic ones in
``tests/test_torch_seq_parallel_ssm.py``.  A dry ``(1, 4)`` mesh holds the
collectives: with the flag no all-reduce of a (B, S, d) activation and a
lower metered peak, without it the counts and bytes of the step as it
was before the sequence split existed.
"""
import dataclasses

import numpy as np
import pytest

from repro_torch.configs import ShapeConfig, get_arch, smoke_of
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import MeshSpec
from repro_torch.launch.steps import input_specs
from repro_torch.parallel.shard import (ALL_GATHER, ALL_REDUCE,
                                        REDUCE_SCATTER, RankMesh)
from test_torch_threads import one_torch_thread  # noqa: F401
from test_torch_tp import AXES, check_split, world2, world4  # noqa: F401

SP = {"seq_parallel_acts": True}
CASES = [("qwen3-0.6b", (1, 2)), ("qwen3-0.6b", (2, 2)),
         ("minicpm3-4b", (1, 2))]
# the dry (1, 4) step of smoke qwen3-0.6b, batch 8 x 64, without the flag:
# collectives by kind as the step counted them before the sequence split
# existed (count, output bytes)
FLAG_OFF = {ALL_GATHER: (74, 1572864), ALL_REDUCE: (55, 5786180),
            REDUCE_SCATTER: (38, 851968)}


@pytest.mark.parametrize("name,shape", CASES,
                         ids=[f"{n}-{s[0]}x{s[1]}" for n, s in CASES])
def test_sequence_split_matches_the_reference(
        world2, world4, name, shape):  # noqa: F811
    check_split(world2 if np.prod(shape) == 2 else world4, name, shape, SP)


def _dry(sp: bool):
    cfg = dataclasses.replace(smoke_of(get_arch("qwen3-0.6b")),
                              seq_parallel_acts=sp)
    rm = RankMesh.dry(MeshSpec((1, 4), AXES))
    fn, args = input_specs(cfg, ShapeConfig("t", "train", 64, 8), rm)
    return dryrun.measure(fn, args, rm), rm.log, cfg


def test_dry_step_has_no_activation_all_reduce_and_a_lower_peak():
    on, log, cfg = _dry(True)
    off, log_off, _ = _dry(False)
    act = (8, 64, cfg.d_model)
    assert act in {s for op, _, s in log_off.calls if op == ALL_REDUCE}
    assert act not in {s for op, _, s in log.calls if op == ALL_REDUCE}
    # the residual's blocks leave the regions by reduce-scatters and enter
    # them by all-gathers over model
    over_model = [(op, s) for op, ax, s in log.calls if ax == ("model",)]
    assert over_model.count((REDUCE_SCATTER, (8, 16, cfg.d_model))) >= 9
    assert over_model.count((ALL_GATHER, act)) >= 9
    assert on["total_per_device"] < off["total_per_device"]
    assert on["flops"] == off["flops"]
    assert {k: (off["coll_count"][k], off["coll_bytes"][k])
            for k in FLAG_OFF} == FLAG_OFF
