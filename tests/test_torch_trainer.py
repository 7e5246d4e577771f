"""The slice as a whole: the port's ``Trainer`` (``repro_torch.train``)
against the reference's, and its crash-equivalence.

- Both trainers of ``smoke_of(qwen3-0.6b)`` (batch 4, seq 64, 6 steps,
  ``log_every=1``) start from one state: the reference's
  ``init_params_sharded`` parameters and ``init_opt_state``, written as a
  step-0 checkpoint by the reference's ``checkpoint.save``, which each
  trainer restores.  The port's loss history (loss, nll, zloss,
  grad_norm, lr) within ``HIST_TOL`` = 1e-5 of the reference's, relative
  (measured at most 2.2e-7).  Its final parameters within ``FINAL_TOL`` =
  2e-2 of the run's Σ lr, the farthest an AdamW step of these settings
  moves a weight (about lr a step), absolute (measured at most 7.0e-3,
  in ``w_gate``): from a zero state Adam divides each gradient element by
  its own magnitude, so where an element is near zero its float32 error
  (1e-6 of the leaf's largest |g|) shows in full in the update.
- The port again with ``FailureInjector(fail_at=(4,))``: one restart from
  the step-3 checkpoint, and final parameters and optimizer state bitwise
  the uninterrupted run's.
- The reference's ``test_loss_decreases_and_failure_recovery`` on the
  port: 80 steps, a failure at 30, the loss falls to under half.
"""
import shutil
import tempfile

import jax
import numpy as np

from repro.configs import get_arch as r_get_arch
from repro.configs import plan_for_mesh as r_plan_for_mesh
from repro.configs import smoke_of as r_smoke_of
from repro.data.pipeline import DataConfig as RDataConfig
from repro.launch.mesh import make_local_mesh
from repro.train import OptConfig as ROptConfig
from repro.train import Trainer as RTrainer
from repro.train import TrainerConfig as RTrainerConfig
from repro.train import checkpoint as RC
from repro.train.optimizer import init_opt_state as r_init_opt_state
from repro_torch.configs import get_arch, plan_for_mesh, smoke_of
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch.mesh import MeshSpec
from repro_torch.train import (FailureInjector, OptConfig, Trainer,
                               TrainerConfig)
from test_torch_threads import one_torch_thread  # noqa: F401
from repro_torch.models.layers import flatten
from test_torch_train_parts import equal_trees, numpy_tree, ref_params

HIST_TOL = 1e-5
FINAL_TOL = 2e-2
B, S, STEPS = 4, 64, 6
OPT = dict(peak_lr=1e-3, warmup_steps=2, total_steps=STEPS)


def _port_trainer(ckpt_dir, injector=None, **tcfg):
    arch = smoke_of(get_arch("qwen3-0.6b"))
    mesh = MeshSpec.local()
    kw = dict(num_steps=STEPS, ckpt_every=3, ckpt_dir=str(ckpt_dir),
              log_every=1)
    kw.update(tcfg)
    return Trainer(arch, mesh, plan_for_mesh(mesh),
                   DataConfig(vocab_size=arch.vocab_size, seq_len=S,
                              global_batch=B),
                   OptConfig(**OPT), TrainerConfig(**kw), injector=injector,
                   device="cpu")


def test_trainer_matches_the_reference_and_survives_a_failure(tmp_path):
    rarch = r_smoke_of(r_get_arch("qwen3-0.6b"))
    rp = ref_params(rarch)
    ropt = ROptConfig(**OPT)
    state = {"params": rp,
             "opt": jax.tree.map(np.asarray, r_init_opt_state(rp, ropt))}
    RC.save(tmp_path / "ref", 0, state)
    for d in ("port", "crash"):
        shutil.copytree(tmp_path / "ref", tmp_path / d)

    mesh = make_local_mesh()
    rtr = RTrainer(rarch, mesh, r_plan_for_mesh(mesh),
                   RDataConfig(vocab_size=rarch.vocab_size, seq_len=S,
                               global_batch=B), ropt,
                   RTrainerConfig(num_steps=STEPS, ckpt_every=3,
                                  ckpt_dir=str(tmp_path / "ref"),
                                  log_every=1, async_ckpt=False))
    r_params, _ = rtr.run()

    tr = _port_trainer(tmp_path / "port")
    params, opt = tr.run()
    assert [h["step"] for h in tr.history] == [h["step"] for h in
                                               rtr.history] == [1, 2, 3, 4, 5,
                                                                6]
    assert set(tr.history[0]) == set(rtr.history[0])
    worst = 0.0
    for got, want in zip(tr.history, rtr.history):
        for k in ("loss", "nll", "zloss", "grad_norm", "lr"):
            err = abs(got[k] - want[k]) / max(abs(want[k]), 1e-30)
            worst = max(worst, err)
            assert err <= HIST_TOL, (got["step"], k, got[k], want[k])
    move = sum(h["lr"] for h in rtr.history)
    got, want = flatten(numpy_tree(params)), flatten(
        jax.tree.map(np.asarray, r_params))
    assert got.keys() == want.keys()
    final = max(float(np.abs(got[k] - want[k]).max()) for k in want) / move
    assert final <= FINAL_TOL, final
    print(f"history {worst:.1e}, final params {final:.1e} of sum lr {move}")
    assert tr.restarts == 0 and int(opt["count"]) == STEPS

    crash = _port_trainer(tmp_path / "crash",
                          injector=FailureInjector(fail_at=(4,)))
    c_params, c_opt = crash.run()
    assert crash.restarts == 1 and crash.injector.fired == [4]
    restores = [r for r in crash.ckpt_log if r["op"] == "restore"]
    assert [r["step"] for r in restores] == [0, 3]
    assert [h["step"] for h in crash.history] == [1, 2, 3, 4, 4, 5, 6]
    equal_trees(c_params, params, "crash-equivalent params")
    equal_trees(c_opt, opt, "crash-equivalent optimizer state")
    assert crash.history[-1]["loss"] == tr.history[-1]["loss"]
    assert all(r.get("write_s") is not None for r in crash.ckpt_log
               if r["op"] == "save")


def test_loss_decreases_and_failure_recovery():
    """The reference's trainer integration case, on the port."""
    arch = smoke_of(get_arch("qwen3_0_6b"))
    mesh = MeshSpec.local()
    data = DataConfig(vocab_size=arch.vocab_size, seq_len=64, global_batch=8)
    with tempfile.TemporaryDirectory() as td:
        tr = Trainer(arch, mesh, plan_for_mesh(mesh), data,
                     OptConfig(peak_lr=1e-3, warmup_steps=10, total_steps=80),
                     TrainerConfig(num_steps=80, ckpt_every=20, ckpt_dir=td,
                                   log_every=20, async_ckpt=False),
                     injector=FailureInjector(fail_at=(30,)), device="cpu")
        tr.run()
        losses = [h["loss"] for h in tr.history]
        assert tr.restarts == 1
        assert losses[-1] < losses[0] * 0.5
