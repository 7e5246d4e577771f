"""Step functions of the LM scaffold (the port of ``repro.launch.steps``,
its training, prefill and decode steps).

``make_train_step`` is the reference's: gradients of ``loss_fn`` (here by
``torch.autograd`` on leaf copies of the parameters), then one AdamW
step; with ``cfg.grad_accum = M > 1`` the batch is split into M
microbatches whose gradients add up in float32 accumulators as ``g/M``,
and whose losses as ``loss/M``.  The reference's sharding constraints are
the port's no-op ``layers.constrain`` (one replica per rank).  The dry
run's ``sds_tree``, ``shardings_of`` and ``input_specs`` come with the
dry-run slice.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs import ArchConfig, ShapeConfig
from repro_torch.models import decode_step, loss_fn, prefill
from repro_torch.models.layers import ParamDef
from repro_torch.train.optimizer import (OptConfig, adamw_update, leaves,
                                         unleaves, value_and_grad)


def batch_defs(cfg: ArchConfig, shape: ShapeConfig, *, decode: bool = False):
    """ParamDef table for one batch (tokens + modality stubs)."""
    B = shape.global_batch
    S = 1 if decode else shape.seq_len
    defs: dict[str, Any] = {
        "tokens": ParamDef((B, S), ("batch", None), dtype="int32"),
    }
    if shape.is_train:
        defs["labels"] = ParamDef((B, S), ("batch", None), dtype="int32")
    if cfg.enc_dec and not decode:
        defs["enc_embeds"] = ParamDef((B, cfg.enc_len, cfg.d_model),
                                      ("batch", None, None),
                                      dtype=cfg.compute_dtype)
    if cfg.n_patches and not decode:
        defs["patch_embeds"] = ParamDef((B, cfg.n_patches, cfg.d_model),
                                        ("batch", None, None),
                                        dtype=cfg.compute_dtype)
        defs["pos3"] = ParamDef((3, B, S), (None, "batch", None),
                                dtype="int32")
    return defs


def _split_micro(x, M: int, batch_axis: int = 0):
    """(…, B, …) -> (M, …, B/M, …) microbatch leading axis."""
    B = x.shape[batch_axis]
    assert B % M == 0, f"batch {B} not divisible by grad_accum {M}"
    x = torch.movedim(x, batch_axis, 0)
    x = x.reshape((M, B // M) + tuple(x.shape[1:]))
    return torch.movedim(x, 1, batch_axis + 1) if batch_axis else x


def make_train_step(cfg: ArchConfig, plan, opt_cfg: OptConfig):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: new trees, the inputs left as they were; the metrics are
    0-d tensors on the parameters' device."""
    M = cfg.grad_accum

    def loss(p, b):
        return loss_fn(p, b, cfg, plan)

    def train_step(params, opt_state, batch):
        if M <= 1:
            loss_v, metrics, grads = value_and_grad(loss, params, batch)
        else:
            micro = {k: _split_micro(v, M, 1 if k == "pos3" else 0)
                     for k, v in batch.items()}
            g_acc = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for p in leaves(params)]
            dev = g_acc[0].device
            loss_v = torch.zeros((), dtype=torch.float32, device=dev)
            aux = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(M):
                mb = {k: v[i] for k, v in micro.items()}
                l_i, m_i, g_i = value_and_grad(loss, params, mb)
                g_acc = [a + g.to(torch.float32) / M
                         for a, g in zip(g_acc, leaves(g_i))]
                loss_v = loss_v + l_i / M
                aux = aux + m_i["aux"] / M
            grads = unleaves(params, g_acc)
            metrics = {"nll": loss_v, "aux": aux,
                       "zloss": torch.zeros((), dtype=torch.float32,
                                            device=dev)}
        params, opt_state, info = adamw_update(params, grads, opt_state,
                                               opt_cfg)
        return params, opt_state, {"loss": loss_v, **metrics, **info}
    return train_step


def make_prefill_step(cfg: ArchConfig, plan, cache_len: int):
    @torch.no_grad()
    def prefill_step(params, batch):
        return prefill(params, batch, cfg, plan, cache_len)
    return prefill_step


def make_decode_step(cfg: ArchConfig, plan):
    @torch.no_grad()
    def serve_step(params, cache, batch):
        new_cache, logits = decode_step(params, cache, batch["tokens"], cfg,
                                        plan)
        return new_cache, torch.argmax(logits, dim=-1)
    return serve_step
