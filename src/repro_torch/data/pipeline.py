"""Deterministic synthetic data pipeline, step-indexed (the port of
``repro.data.pipeline``).

Batches are a pure function of (seed, step), so a restarted trainer replays
the exact stream (no data-loader state in the checkpoint).  The generator
is an affine bigram process with noise, x_{t+1} = (a·x_t + b) mod V except
ε-noise: a pattern a causal LM can learn, so smoke-scale training shows a
decreasing loss.

``host_batch`` is the reference's numpy, draw for draw (PCG64DXSM over
``[seed, step]``), so both packages see the same bytes; ``device_batch``
puts it on the mesh's device.  The port keeps one replica of the LM per
rank, so a rank's batch is the whole global batch.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShardingPlan
from repro_torch.core.speculative import resolve_device


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


def device_batch(batch: dict, mesh, plan: ShardingPlan, device=None):
    """The host batch as tensors on the mesh's device (``mesh_device``)."""
    dev = mesh_device(mesh, device)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in batch.items()}


class DataLoader:
    """Step-indexed iterator over ``device_batch(host_batch(...))``."""

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
                         self.mesh, self.plan, self.device)
        self.step += 1
        return b
