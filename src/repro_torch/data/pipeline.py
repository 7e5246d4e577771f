"""Deterministic synthetic data pipeline, step-indexed (the port of
``repro.data.pipeline``).

Batches are a pure function of (seed, step), so a restarted trainer replays
the exact stream (no data-loader state in the checkpoint).  The generator
is an affine bigram process with noise, x_{t+1} = (a·x_t + b) mod V except
ε-noise: a pattern a causal LM can learn, so smoke-scale training shows a
decreasing loss.

``host_batch`` is the reference's numpy, draw for draw (PCG64DXSM over
``[seed, step]``), so both packages see the same bytes; ``device_batch``
puts this rank's rows of it on the mesh's device: on a built
``DeviceMesh`` the batch dim (axis 1 of ``pos3``) split by the plan's
batch spec, as the reference's ``NamedSharding`` places it (at
``grad_accum > 1``, split microbatch by microbatch); for a ``MeshSpec``
or no mesh, the whole batch.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShardingPlan
from repro_torch.core.speculative import resolve_device
from repro_torch.parallel.shard import as_rank_mesh, shard_of


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    noise: float = 0.05
    mult: int = 31
    add: int = 17


def host_batch(cfg: DataConfig, step: int, arch: ArchConfig | None = None):
    """Pure (seed, step) -> batch of numpy arrays (tokens, labels, stubs)."""
    rng = np.random.default_rng(np.random.PCG64DXSM(
        [cfg.seed, step]))
    B, S, V = cfg.global_batch, cfg.seq_len, cfg.vocab_size
    x = rng.integers(0, V, B).astype(np.int64)
    seq = np.empty((B, S + 1), np.int64)
    for t in range(S + 1):  # affine orbit x_{t+1} = (a·x_t + b) mod V
        seq[:, t] = x
        x = (cfg.mult * x + cfg.add) % V
    noise_mask = rng.random((B, S + 1)) < cfg.noise
    seq = np.where(noise_mask, rng.integers(0, V, (B, S + 1)), seq)
    batch = {"tokens": seq[:, :S].astype(np.int32),
             "labels": seq[:, 1:].astype(np.int32)}
    if arch is not None and arch.enc_dec:
        batch["enc_embeds"] = rng.normal(
            0, 1, (B, arch.enc_len, arch.d_model)).astype(np.float32)
    if arch is not None and arch.n_patches:
        batch["patch_embeds"] = rng.normal(
            0, 0.02, (B, arch.n_patches, arch.d_model)).astype(np.float32)
        batch["pos3"] = np.broadcast_to(np.arange(S, dtype=np.int32),
                                        (3, B, S)).copy()
    return batch


def mesh_device(mesh, device=None) -> torch.device:
    """The device a rank of ``mesh`` runs on: a ``DeviceMesh``'s own (its
    current CUDA device, or the CPU of gloo ranks); for a ``MeshSpec`` or
    ``None``, ``device`` (CUDA unless the caller asks for the CPU)."""
    dt = getattr(mesh, "device_type", None)
    if dt == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    if dt is not None:
        return torch.device(dt)
    return resolve_device(device)


def batch_spec(key: str, shape, plan: ShardingPlan) -> tuple:
    """The plan's spec of one batch leaf: its batch dim over the batch
    axes (axis 1 of ``pos3``, axis 0 of the others)."""
    dims: tuple = ("batch",) + (None,) * (len(shape) - 1)
    if key == "pos3":
        dims = (None, "batch", None)
    return plan.spec(dims, tuple(shape))


def device_batch(batch: dict, mesh, plan: ShardingPlan, device=None,
                 grad_accum: int = 1):
    """This rank's rows of the host batch as tensors on the mesh's device
    (``mesh_device``).  With ``grad_accum = M > 1`` they are this rank's
    block of each of the M contiguous microbatches of the global batch, in
    microbatch order, so that the train step's split of its rows into M
    gives each microbatch the reference's rows (it cuts the global batch
    into M and then shards each microbatch over the batch axes)."""
    dev = mesh_device(mesh, device)
    rm = as_rank_mesh(mesh)
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if rm is not None:
            bd = 1 if k == "pos3" else 0
            B, M = t.shape[bd], grad_accum
            if B % M:
                raise ValueError(f"batch {B} does not split into {M} "
                                 "microbatches")
            micro = t.unflatten(bd, (M, B // M))
            spec = batch_spec(k, micro.shape[:bd] + micro.shape[bd + 1:],
                              plan)
            t = shard_of(micro, spec[:bd] + (None,) + spec[bd:],
                         rm).flatten(bd, bd + 1)
        out[k] = t.to(dev)
    return out


class DataLoader:
    """Step-indexed iterator over ``device_batch(host_batch(...))``, its
    rows grouped by ``arch.grad_accum`` microbatches when ``arch`` is
    given."""

    def __init__(self, cfg: DataConfig, mesh, plan: ShardingPlan,
                 arch: ArchConfig | None = None, start_step: int = 0,
                 device=None):
        self.cfg, self.mesh, self.plan, self.arch = cfg, mesh, plan, arch
        self.device = mesh_device(mesh, device)
        self.step = start_step

    def __iter__(self):
        return self

    def __next__(self):
        b = device_batch(host_batch(self.cfg, self.step, self.arch),
                         self.mesh, self.plan, self.device,
                         self.arch.grad_accum if self.arch else 1)
        self.step += 1
        return b
