"""Step functions of the LM scaffold and the dry run's input builders
(the port of ``repro.launch.steps``).

``make_train_step`` is the reference's: gradients of ``loss_fn`` (here by
``torch.autograd`` on leaf copies of the parameters), then one AdamW
step; with ``cfg.grad_accum = M > 1`` the batch is split into M
microbatches whose gradients add up in float32 accumulators as ``g/M``,
and whose losses as ``loss/M``.

On a mesh (run the steps inside ``parallel.shard.set_mesh``) the trees are
this rank's shards under ``plan.spec`` and the batch this rank's rows.
The gradients come out of the backward pass already reduced and sharded
like the parameters (``parallel.shard.GatherLayer``: the reference's
``constrain_grads``), AdamW runs on the shards, and the metrics are the
mean over the batch ranks.  At ``grad_accum = M > 1`` the batch must
hold this rank's block of each of the M global microbatches, in order
(``data.pipeline.device_batch(..., grad_accum=M)``), so that each
microbatch is made of the reference's rows: an MoE's load-balance term,
taken per microbatch, depends on which rows those are.  At ``M > 1`` a
step gathers every non-expert leaf once over the batch axes, as the
reference's step does (its spec with the ``fsdp`` dim dropped: the
``model`` blocks stay), before the first microbatch
(``parallel.shard.gather_batch``); inside the microbatches
(``parallel.shard.batch_gathered``) a layer then gathers such a leaf only
over ``model``, where a region runs whole, in the forward pass and in the
remat recompute alike.  Each microbatch's gradient of a gathered leaf is
reduced over the batch axes into this rank's float32 shard accumulator
(``reduce_batch_grad``), and the gathered copies are dropped before the
AdamW step.  The experts' leaves stay sharded and are gathered per layer
in every microbatch.

``input_specs(arch, shape, mesh)`` gives (step_fn, args) of one dry-run
cell: the torch analogue of a ``ShapeDtypeStruct`` with a
``NamedSharding`` is a tensor on the ``meta`` device at the leaf's
per-rank shape (``sds_tree``) beside its spec (``shardings_of``), so
nothing is allocated.  A cache is placed by the plan's spec of all its
dims, as the reference places it (``sds_tree(cdefs, mesh, plan)``): its
batch, its ``"tp"`` dims (RWKV-6's heads, Mamba's ``di``) and, for a
batch of one (``long_500k``), its slots over ``data``.  The step a cell
meters is the split one: on a dry mesh with a ``model`` axis each region
computes its own share (``models.model``), so the FLOPs and the
collectives per rank are those of the split step.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs import ArchConfig, ShapeConfig, plan_for_mesh
from repro_torch.parallel.shard import (RankMesh, ShardedLeaf, batch_gathered,
                                      batch_mean, current_mesh, gather_batch,
                                      local_shape, map_tree,
                                      reduce_batch_grad, set_mesh)
from repro_torch.models import (cache_defs, decode_step, loss_fn,
                                param_defs, prefill)
from repro_torch.models.layers import (DTYPES, ParamDef, flatten, specs_of,
                                       unflatten)
from repro_torch.models.model import gather_splits
from repro_torch.train.optimizer import (OptConfig, adamw_update, leaves,
                                         opt_state_defs, unleaves,
                                         value_and_grad)


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
    defs = param_defs(cfg)
    specs = specs_of(defs, plan)
    # the leaves gathered once a step at M > 1: all but the experts'
    once = ["exp" not in d.dims for d in leaves(defs)]
    paths = leaves(unflatten({k: k for k in flatten(defs)}))

    def loss(p, b):
        return loss_fn(p, b, cfg, plan)

    def train_step(params, opt_state, batch):
        if M <= 1:
            loss_v, metrics, grads = value_and_grad(loss, params, batch)
        else:
            rm = current_mesh()
            ax = rm.batch_axes(plan) if rm is not None else ()
            splits = gather_splits(cfg, plan)
            flat = [(p, sp, o and bool(ax), splits.get(k)) for p, sp, o, k
                    in zip(leaves(params), leaves(specs), once, paths)]
            held = unleaves(params, [gather_batch(p, sp, rm, ax, kept) if o
                                     else p for p, sp, o, kept in flat])
            micro = {k: _split_micro(v, M, 1 if k == "pos3" else 0)
                     for k, v in batch.items()}
            g_acc = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for p, *_ in flat]
            dev = g_acc[0].device
            loss_v = torch.zeros((), dtype=torch.float32, device=dev)
            aux = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(M):
                mb = {k: v[i] for k, v in micro.items()}
                with batch_gathered(bool(ax)):
                    l_i, m_i, g_i = value_and_grad(loss, held, mb)
                g_acc = [a + (reduce_batch_grad(g, sp, rm, ax, kept) if o
                              else g).to(torch.float32) / M
                         for a, g, (_, sp, o, kept) in zip(g_acc, leaves(g_i),
                                                           flat)]
                loss_v = loss_v + l_i / M
                aux = aux + m_i["aux"] / M
            del held, flat, g_i
            grads = unleaves(params, g_acc)
            metrics = {"nll": loss_v, "aux": aux,
                       "zloss": torch.zeros((), dtype=torch.float32,
                                            device=dev)}
        params, opt_state, info = adamw_update(params, grads, opt_state,
                                               opt_cfg, specs=specs)
        out = {"loss": loss_v, **metrics}
        if current_mesh() is not None:     # the batch ranks' mean
            keys = sorted(out)
            got = batch_mean(torch.stack([out[k] for k in keys]), plan)
            out = {k: got[i] for i, k in enumerate(keys)}
        return params, opt_state, {**out, **info}
    return train_step


def make_prefill_step(cfg: ArchConfig, plan, cache_len: int,
                      global_batch: int | None = None):
    @torch.no_grad()
    def prefill_step(params, batch):
        return prefill(params, batch, cfg, plan, cache_len, global_batch)
    return prefill_step


def make_decode_step(cfg: ArchConfig, plan, global_batch: int | None = None,
                     cache_len: int | None = None):
    """``serve_step(params, cache, batch)``; on a mesh ``global_batch`` and
    ``cache_len`` give the cache's layout (``models.decode_step``)."""
    @torch.no_grad()
    def serve_step(params, cache, batch):
        new_cache, logits = decode_step(params, cache, batch["tokens"], cfg,
                                        plan, global_batch=global_batch,
                                        cache_len=cache_len)
        return new_cache, torch.argmax(logits, dim=-1)
    return serve_step


# --------------------------------------------------------------------------
# Dry-run inputs


def cache_specs(cdefs, plan) -> dict:
    """Spec tree of a cache: ``plan.spec`` of every dim of each leaf."""
    return specs_of(cdefs, plan)


def shardings_of(defs, mesh, plan, specs=None) -> dict:
    """``ShardedLeaf`` of every definition (``specs``: a spec tree in
    place of ``plan.spec`` of each, as for caches)."""
    specs = specs if specs is not None else specs_of(defs, plan)
    return map_tree(lambda d, sp: ShardedLeaf.of(d.shape, sp, mesh.names),
                    defs, specs)


def sds_tree(defs, mesh, plan, specs=None) -> dict:
    """Tensors on the ``meta`` device at each leaf's per-rank shape on
    ``mesh`` (a ``RankMesh``): nothing is allocated."""
    specs = specs if specs is not None else specs_of(defs, plan)
    return map_tree(lambda d, sp: torch.empty(
        local_shape(d.shape, sp, mesh.sizes), dtype=DTYPES[d.dtype],
        device="meta"), defs, specs)


def _on_mesh(rm: RankMesh, fn):
    def run(*args):
        with set_mesh(rm):
            return fn(*args)
    return run


def input_specs(arch: ArchConfig, shape: ShapeConfig, mesh,
                opt_cfg: OptConfig | None = None):
    """(step_fn, args) of one dry-run cell: ``args`` are ``meta`` tensors
    at the per-rank shapes of a rank of ``mesh`` (a ``MeshSpec``, or a
    ``RankMesh`` such as ``RankMesh.dry(spec)``, whose ``log`` then
    records the step's collectives), and ``step_fn`` runs on that mesh."""
    rm = mesh if isinstance(mesh, RankMesh) else RankMesh.dry(mesh)
    plan = plan_for_mesh(rm)
    opt_cfg = opt_cfg or OptConfig(state_dtype=arch.opt_state_dtype)
    pdefs = param_defs(arch)
    params = sds_tree(pdefs, rm, plan)

    if shape.kind == "train":
        opt = sds_tree(opt_state_defs(pdefs, opt_cfg), rm, plan)
        batch = sds_tree(batch_defs(arch, shape), rm, plan)
        fn = make_train_step(arch, plan, opt_cfg)
        return _on_mesh(rm, fn), (params, opt, batch)

    if shape.kind == "prefill":
        batch = sds_tree(batch_defs(arch, shape), rm, plan)
        fn = make_prefill_step(arch, plan, shape.seq_len, shape.global_batch)
        return _on_mesh(rm, fn), (params, batch)

    if shape.kind == "decode":
        cdefs = cache_defs(arch, shape.global_batch, shape.seq_len)
        cache = sds_tree(cdefs, rm, plan, cache_specs(cdefs, plan))
        batch = sds_tree(batch_defs(arch, shape, decode=True), rm, plan)
        fn = make_decode_step(arch, plan, shape.global_batch, shape.seq_len)
        return _on_mesh(rm, fn), (params, cache, batch)

    raise ValueError(shape.kind)
