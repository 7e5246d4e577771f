"""Training loop with checkpoint/restart fault tolerance (the port of
``repro.train.trainer``).

The loop is crash-equivalent: state = (params, opt_state) is checkpointed
every ``ckpt_every`` steps (async), the data stream is a pure function of
the step index, and any step-time failure (injected or real) restores the
newest verified checkpoint and replays the stream from there.
``FailureInjector`` simulates node failures at chosen steps.  A restore
first waits for the checkpoint write in flight, so the run does not
depend on how long a write takes.

``ckpt_log`` records each save (the host snapshot's seconds, the
background write's seconds once it has ended, bytes) and each restore
(seconds, bytes).

On a built ``DeviceMesh`` every rank holds its shards of the parameters
and of AdamW's m and v (``plan.spec``) and its rows of each batch, and
runs the step on the mesh (``parallel.shard.set_mesh``).  A checkpoint is
gathered leaf by leaf and written by rank 0 in the one-device format, and
every rank waits for the write in flight before a restore, which gives
each rank its shards of the newest checkpoint (on any mesh shape).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import ArchConfig, ShardingPlan
from repro_torch.core.comm import shard_uniform
from repro_torch.data.pipeline import DataConfig, DataLoader, mesh_device
from repro_torch.parallel.shard import as_rank_mesh, set_mesh, shard_of
from repro_torch.models import param_defs
from repro_torch.models.layers import ParamDef, flatten, specs_of, unflatten
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import OptConfig, init_opt_state


class FailureInjector:
    """Raises once at each configured step: a stand-in for a node loss."""

    def __init__(self, fail_at: tuple[int, ...] = ()):
        self.pending = set(fail_at)
        self.fired: list[int] = []

    def maybe_fail(self, step: int):
        if step in self.pending:
            self.pending.discard(step)
            self.fired.append(step)
            raise RuntimeError(f"injected node failure at step {step}")


@dataclasses.dataclass
class TrainerConfig:
    num_steps: int = 200
    ckpt_every: int = 50
    ckpt_dir: str = "checkpoints"
    keep: int = 3
    log_every: int = 10
    seed: int = 0
    async_ckpt: bool = True


class Trainer:
    """``Trainer(arch, mesh, plan, data_cfg, ...)``: ``mesh`` is a
    ``MeshSpec`` (one device, ``device``: CUDA unless the caller asks for
    the CPU; the whole model) or a built ``DeviceMesh`` (its rank's device
    and shards; ``plan`` is ``plan_for_mesh`` of it)."""

    def __init__(self, arch: ArchConfig, mesh, plan: ShardingPlan,
                 data_cfg: DataConfig, opt_cfg: OptConfig | None = None,
                 tcfg: TrainerConfig | None = None,
                 injector: FailureInjector | None = None, device=None):
        self.arch, self.mesh, self.plan = arch, mesh, plan
        self.device = mesh_device(mesh, device)
        self.data_cfg = data_cfg
        self.opt_cfg = opt_cfg or OptConfig()
        self.tcfg = tcfg or TrainerConfig()
        self.injector = injector
        self.pdefs = param_defs(arch)
        self.param_specs = specs_of(self.pdefs, plan)
        self.rank_mesh = as_rank_mesh(mesh)
        self.state_specs = {"params": self.param_specs,
                            "opt": {"m": self.param_specs,
                                    "v": self.param_specs}}
        # local import: launch.steps imports repro_torch.train.optimizer
        from repro_torch.launch.steps import make_train_step
        self._step_fn = make_train_step(arch, plan, self.opt_cfg)
        self.history: list[dict] = []
        self.ckpt_log: list[dict] = []
        self.restarts = 0

    # -- state ------------------------------------------------------------
    def init_state(self):
        params = init_params_sharded(self.pdefs, self.mesh, self.param_specs,
                                     self.tcfg.seed, self.device)
        return params, init_opt_state(params, self.opt_cfg)

    def save(self, step, params, opt_state):
        tree = {"params": params, "opt": opt_state}
        t0 = time.perf_counter()
        rec = dict(op="save", step=step, bytes=ckpt.nbytes(tree))
        kw = dict(keep=self.tcfg.keep, mesh=self.mesh, specs=self.state_specs)
        if self.tcfg.async_ckpt:
            rec["thread"] = ckpt.save_async(self.tcfg.ckpt_dir, step, tree,
                                            **kw)
        else:
            ckpt.save(self.tcfg.ckpt_dir, step, tree, **kw)
        rec["snapshot_s"] = time.perf_counter() - t0
        self.ckpt_log.append(rec)

    def wait(self):
        """Wait for the checkpoint writes in flight (if any)."""
        for rec in self.ckpt_log:
            t = rec.pop("thread", None)
            if t is not None:
                t.join()
                rec["write_s"] = t.seconds

    def restore(self):
        self.wait()
        if self.rank_mesh is not None:   # rank 0's write has ended
            dist.barrier()
        t0 = time.perf_counter()
        step, tree = ckpt.restore(self.tcfg.ckpt_dir, mesh=self.mesh,
                                  specs=self.state_specs, device=self.device)
        if step is None:
            return 0, *self.init_state()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.ckpt_log.append(dict(op="restore", step=step,
                                  seconds=time.perf_counter() - t0,
                                  bytes=ckpt.nbytes(tree)))
        return step, tree["params"], tree["opt"]

    # -- loop ---------------------------------------------------------------
    def run(self, num_steps: int | None = None):
        num_steps = num_steps or self.tcfg.num_steps
        step, params, opt_state = self.restore()
        # every rank restores the same checkpoint (``restore`` waits for
        # the write in flight on all of them) and then steps in lockstep
        step = shard_uniform(step)
        loader = DataLoader(self.data_cfg, self.mesh, self.plan, self.arch,
                            start_step=step, device=self.device)
        t0 = time.time()
        while step < num_steps:
            try:
                if self.injector:
                    self.injector.maybe_fail(step)
                batch = next(loader)
                with set_mesh(self.rank_mesh):
                    params, opt_state, metrics = self._step_fn(
                        params, opt_state, batch)
                step += 1
                if step % self.tcfg.log_every == 0 or step == num_steps:
                    m = {k: float(v) for k, v in metrics.items()}
                    m.update(step=step, wall=round(time.time() - t0, 2))
                    self.history.append(m)
                if step % self.tcfg.ckpt_every == 0 or step == num_steps:
                    self.save(step, params, opt_state)
            except RuntimeError as e:
                if "injected node failure" not in str(e):
                    raise
                # node loss: restore newest verified ckpt, replay stream
                self.restarts += 1
                step, params, opt_state = self.restore()
                step = shard_uniform(step)
                loader = DataLoader(self.data_cfg, self.mesh, self.plan,
                                    self.arch, start_step=step,
                                    device=self.device)
        self.wait()
        return params, opt_state


def leaf_seed(seed: int, i: int) -> int:
    """The generator seed of the ``i``-th leaf (sorted-name order)."""
    return int(np.random.SeedSequence([seed, i]).generate_state(
        1, np.uint64)[0] >> 1)


def init_params_sharded(pdefs, mesh, specs, seed: int, device=None):
    """Initialise the parameters on the mesh's device (``device`` for a
    ``MeshSpec``): one ``torch.Generator`` per leaf, seeded from ``seed``
    and the leaf's index in sorted-name order (the reference folds the
    index into its key).  The values are the port's own.  On a built
    ``DeviceMesh`` each rank draws the whole leaf, one leaf at a time on
    its device, and keeps its shard under ``specs`` (the tree of
    ``plan.spec``), so the gathered tree is the one-device tree bit for
    bit on any mesh."""
    dev = mesh_device(mesh, device)
    rm = as_rank_mesh(mesh)
    flat: dict[str, ParamDef] = flatten(pdefs)
    flat_specs = flatten(specs) if rm is not None else {}
    out = {}
    for i, name in enumerate(sorted(flat)):
        g = torch.Generator(device=dev).manual_seed(leaf_seed(seed, i))
        t = flat[name].initializer(g, dev)
        out[name] = shard_of(t, flat_specs[name], rm) if rm is not None else t
    return unflatten(out)
