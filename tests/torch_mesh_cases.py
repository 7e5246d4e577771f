"""Rank-side cases of the LM on a mesh of gloo ranks, for
``test_torch_world.World`` (``tests/test_torch_shard.py``,
``tests/test_torch_mesh_train.py``, ``tests/test_torch_dryrun_lm.py``).

Each case builds (once per world) the ``DeviceMesh`` of a spec, takes
numpy inputs and plain values, and returns numpy arrays and python
values; trees are returned gathered (``unshard``) beside the shapes of
this rank's shards.  They import only ``repro_torch``.
"""
from __future__ import annotations

import numpy as np

from test_torch_world import mesh


def _rm(shape, axes):
    from repro_torch.parallel.shard import RankMesh
    return RankMesh.of(mesh(tuple(shape), tuple(axes)))


def _arch(name: str, **over):
    import dataclasses
    from repro_torch.configs import get_arch, smoke_of
    cfg = smoke_of(get_arch(name))
    return dataclasses.replace(cfg, **over) if over else cfg


def _np(tree):
    import torch
    from repro_torch.models.layers import tree_map
    return tree_map(lambda t: t.detach().cpu().numpy()
                    if isinstance(t, torch.Tensor) else np.asarray(t), tree)


def _shapes(tree):
    from repro_torch.models.layers import tree_map
    return tree_map(lambda t: tuple(t.shape), tree)


def _gathered(tree, specs, rm):
    from repro_torch.parallel.shard import unshard_tree
    return unshard_tree(tree, specs, rm)


def roundtrip(shape, axes, arrays: dict, specs: dict):
    """``shard_of`` then ``unshard`` of each array: (the gathered arrays,
    this rank's blocks, its coordinate)."""
    import torch
    from repro_torch.parallel.shard import shard_of, unshard
    rm = _rm(shape, axes)
    blocks = {k: shard_of(torch.from_numpy(a), specs[k], rm)
              for k, a in arrays.items()}
    back = {k: unshard(b, specs[k], rm).numpy() for k, b in blocks.items()}
    return back, {k: b.numpy() for k, b in blocks.items()}, rm.coord


def gather_grads(shape, axes, specs: dict):
    """Gradients of this rank's shards of 8 x 8 leaves gathered through
    ``GatherLayer`` under ``specs``, for the loss Σ W ⊙ X where X is
    ``arange(64) * (data coordinate + 1)``; (the gradients, the
    coordinate)."""
    import torch
    from repro_torch.configs import plan_for_mesh
    from repro_torch.parallel.shard import set_mesh, gather, shard_of
    m = mesh(tuple(shape), tuple(axes))
    rm = _rm(shape, axes)
    plan = plan_for_mesh(m)
    X = torch.arange(64, dtype=torch.float32).reshape(8, 8) \
        * (rm.coord["data"] + 1)
    whole = torch.ones(8, 8)
    out = {}
    for k, sp in specs.items():
        w = shard_of(whole, sp, rm).requires_grad_(True)
        with set_mesh(rm):
            loss = (gather(w, sp, plan) * X).sum()
        (g,) = torch.autograd.grad(loss, [w])
        out[k] = g.numpy()
    return out, rm.coord


def global_norm(shape, axes):
    """``optimizer.global_norm`` of a leaf split over both axes and a
    replicated one, from this rank's shards."""
    import torch
    from repro_torch.parallel.shard import set_mesh, shard_of
    from repro_torch.train.optimizer import global_norm as gn
    rm = _rm(shape, axes)
    r = np.random.default_rng(3)
    a = torch.from_numpy(r.normal(size=(8, 8)).astype(np.float32))
    b = torch.from_numpy(r.normal(size=(4,)).astype(np.float32))
    specs = {"a": ("data", "model"), "b": (None,)}
    tree = {"a": shard_of(a, specs["a"], rm), "b": shard_of(b, specs["b"], rm)}
    with set_mesh(rm):
        return float(gn(tree, specs))


def init_sharded(shape, axes, name: str, seed: int):
    """``init_params_sharded`` on the mesh: (gathered tree, shard shapes)."""
    from repro_torch.configs import plan_for_mesh
    from repro_torch.models import param_defs
    from repro_torch.models.layers import specs_of
    from repro_torch.train.trainer import init_params_sharded
    m = mesh(tuple(shape), tuple(axes))
    rm = _rm(shape, axes)
    cfg = _arch(name)
    plan = plan_for_mesh(m)
    specs = specs_of(param_defs(cfg), plan)
    params = init_params_sharded(param_defs(cfg), m, specs, seed)
    return _np(_gathered(params, specs, rm)), _shapes(params)


def train(shape, axes, name: str, params: dict, batches: list, opt: dict,
          over: dict | None = None, log: bool = False):
    """``make_train_step`` on the mesh from the whole numpy ``params``, one
    step per host batch in ``batches`` (laid out by ``device_batch`` for
    the config's ``grad_accum``).  Returns a dict: ``losses`` and
    ``grad_norms`` of every step, ``metrics`` of the last, the gathered
    ``params``, ``m`` and ``v``, the shard shapes of params and m
    (``pshapes``, ``mshapes``), the collectives of the first step when
    ``log`` (``coll``)."""
    from repro_torch.configs import plan_for_mesh
    from repro_torch.data.pipeline import device_batch
    from repro_torch.parallel.shard import (CollectiveLog, map_tree, set_mesh,
                                            shard_of)
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import param_defs, params_from_numpy
    from repro_torch.models.layers import specs_of
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    m = mesh(tuple(shape), tuple(axes))
    rm = _rm(shape, axes)
    cfg = _arch(name, **(over or {}))
    plan = plan_for_mesh(m)
    specs = specs_of(param_defs(cfg), plan)
    p = map_tree(lambda t, sp: shard_of(t, sp, rm),
                 params_from_numpy(params, "cpu"), specs)
    opt_cfg = OptConfig(**opt)
    state = init_opt_state(p, opt_cfg)
    step = make_train_step(cfg, plan, opt_cfg)
    losses, norms, metrics, coll = [], [], {}, None
    for i, hb in enumerate(batches):
        b = device_batch(hb, m, plan, grad_accum=cfg.grad_accum)
        if log and i == 0:
            rm.log = CollectiveLog()
        with set_mesh(rm):
            p, state, metrics = step(p, state, b)
        if log and i == 0:
            coll = (dict(rm.log.count), dict(rm.log.bytes))
            rm.log = None
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    return dict(losses=losses, grad_norms=norms,
                metrics={k: float(v) for k, v in metrics.items()},
                params=_np(_gathered(p, specs, rm)),
                m=_np(_gathered(state["m"], specs, rm)),
                v=_np(_gathered(state["v"], specs, rm)),
                pshapes=_shapes(p), mshapes=_shapes(state["m"]), coll=coll)


def serve(shape, axes, name: str, batch: int, prompt_len: int, gen: int,
          seed: int):
    """``launch.serve.serve`` on the mesh (tokens whole), and the prefill
    step's last logits on this rank's rows, gathered."""
    from repro_torch.configs import plan_for_mesh
    from repro_torch.data.pipeline import batch_spec
    from repro_torch.launch.mesh import MeshSpec
    from repro_torch.launch.serve import init_params_placed, serve_inputs
    from repro_torch.launch.serve import serve as serve_
    from repro_torch.parallel.shard import batch_rows, set_mesh, unshard
    from repro_torch.launch.steps import make_prefill_step
    m = mesh(tuple(shape), tuple(axes)) if shape else None
    rm = _rm(shape, axes) if shape else None
    cfg = _arch(name)
    plan = plan_for_mesh(m if m is not None else MeshSpec.local())
    tokens, _ = serve_(cfg, m if m is not None else MeshSpec.local(), plan,
                       batch=batch, prompt_len=prompt_len, gen=gen,
                       seed=seed, device="cpu")
    params = init_params_placed(cfg, plan, seed, m, "cpu")
    inp = {k: batch_rows(v, batch_spec(k, v.shape, plan), rm)
           for k, v in serve_inputs(cfg, batch=batch, prompt_len=prompt_len,
                                    seed=seed, device="cpu").items()}
    with set_mesh(rm):
        _, logits = make_prefill_step(cfg, plan, prompt_len, batch)(params,
                                                                    inp)
    if rm is not None:
        whole = (batch,) + tuple(logits.shape[1:])
        logits = unshard(logits, plan.spec(("batch", None, None), whole), rm)
    return tokens.numpy(), logits.numpy()


def ckpt_save(shape, axes, name: str, path: str, seed: int, step: int):
    """Sharded params and a zero AdamW state saved with their specs."""
    import torch.distributed as dist
    from repro_torch.configs import plan_for_mesh
    from repro_torch.launch.mesh import MeshSpec
    from repro_torch.models import param_defs
    from repro_torch.models.layers import specs_of
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.trainer import init_params_sharded
    m = mesh(tuple(shape), tuple(axes)) if shape else None
    cfg = _arch(name)
    plan = plan_for_mesh(m if m is not None else MeshSpec.local())
    specs = specs_of(param_defs(cfg), plan)
    params = init_params_sharded(param_defs(cfg), m, specs, seed, "cpu")
    opt = init_opt_state(params, OptConfig())
    opt["m"] = {k: v for k, v in params.items()}     # nonzero m: the params
    ckpt.save(path, step, {"params": params, "opt": opt}, mesh=m,
              specs={"params": specs, "opt": {"m": specs, "v": specs}})
    if m is not None:
        dist.barrier()
    return True


def ckpt_save_peak(shape, axes, name: str, path: str, seed: int):
    """A sharded save of the parameters and AdamW's m and v under the dry
    run's meter (``dryrun.StepMeter``: live storages, counted from the
    tree's own): (rank, peak live bytes beyond the tree's shards, the
    largest whole leaf's bytes, the whole tree's bytes)."""
    import math
    import torch
    import torch.distributed as dist
    from repro_torch.configs import plan_for_mesh
    from repro_torch.launch.dryrun import StepMeter
    from repro_torch.models import param_defs
    from repro_torch.models.layers import DTYPES, specs_of
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.optimizer import OptConfig, init_opt_state, leaves
    from repro_torch.train.trainer import init_params_sharded
    m = mesh(tuple(shape), tuple(axes))
    cfg = _arch(name)
    plan = plan_for_mesh(m)
    defs = param_defs(cfg)
    specs = specs_of(defs, plan)
    opt_cfg = OptConfig()
    params = init_params_sharded(defs, m, specs, seed, "cpu")
    opt = init_opt_state(params, opt_cfg)
    tree = {"params": params, "m": opt["m"], "v": opt["v"]}
    meter = StepMeter()
    for t in leaves(tree):
        meter.track(t)
    base = meter.live
    with meter:
        ckpt.save(path, 1, tree, mesh=m,
                  specs={"params": specs, "m": specs, "v": specs})
    dist.barrier()
    size = lambda dt: torch.empty((), dtype=DTYPES[dt]).element_size()  # noqa: E731
    whole = [math.prod(d.shape) * size(d.dtype) for d in leaves(defs)]
    state = [math.prod(d.shape) * size(opt_cfg.state_dtype)
             for d in leaves(defs)]
    return (dist.get_rank(), meter.peak - base, max(whole + state),
            sum(whole) + 2 * sum(state))


def ckpt_restore(shape, axes, name: str, path: str):
    """Restore onto the mesh: (step, gathered tree, shard shapes)."""
    from repro_torch.configs import plan_for_mesh
    from repro_torch.models import param_defs
    from repro_torch.models.layers import specs_of
    from repro_torch.train import checkpoint as ckpt
    m = mesh(tuple(shape), tuple(axes))
    rm = _rm(shape, axes)
    cfg = _arch(name)
    plan = plan_for_mesh(m)
    specs = specs_of(param_defs(cfg), plan)
    all_specs = {"params": specs, "opt": {"m": specs, "v": specs}}
    step, tree = ckpt.restore(path, mesh=m, specs=all_specs)
    return step, _np(_gathered(tree, all_specs, rm)), _shapes(tree)


def trainer(shape, axes, name: str, path: str, steps: int, fail_at: tuple,
            ckpt_every: int):
    """A ``Trainer`` on the mesh through an injected failure: (history
    losses, restarts, gathered final params)."""
    from repro_torch.configs import plan_for_mesh
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.train import (FailureInjector, OptConfig, Trainer,
                                   TrainerConfig)
    m = mesh(tuple(shape), tuple(axes))
    rm = _rm(shape, axes)
    cfg = _arch(name)
    plan = plan_for_mesh(m)
    tr = Trainer(cfg, m, plan,
                 DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                            global_batch=8),
                 OptConfig(peak_lr=1e-3, warmup_steps=2, total_steps=steps),
                 TrainerConfig(num_steps=steps, ckpt_every=ckpt_every,
                               ckpt_dir=path, log_every=1),
                 injector=FailureInjector(tuple(fail_at)))
    params, _ = tr.run()
    return ([h["loss"] for h in tr.history], tr.restarts,
            _np(_gathered(params, tr.param_specs, rm)))


def train_plain(name: str, params: dict, batches: list, opt: dict):
    """``C.train``'s steps without a mesh (whole tensors, one process):
    (losses, metrics, params)."""
    from repro_torch.configs import NO_SHARDING
    from repro_torch.data.pipeline import device_batch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import params_from_numpy
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    cfg = _arch(name)
    p = params_from_numpy(params, "cpu")
    opt_cfg = OptConfig(**opt)
    state = init_opt_state(p, opt_cfg)
    step = make_train_step(cfg, NO_SHARDING, opt_cfg)
    losses, metrics = [], {}
    for hb in batches:
        p, state, metrics = step(p, state, device_batch(hb, None, NO_SHARDING,
                                                        "cpu"))
        losses.append(float(metrics["loss"]))
    return losses, {k: float(v) for k, v in metrics.items()}, _np(p)


def ckpt_load(path: str):
    """The newest checkpoint whole, without a mesh: (step, numpy tree)."""
    from repro_torch.train import checkpoint as ckpt
    step, tree = ckpt.restore(path)
    return step, _np(tree)


def example_train(shape, axes, path: str, steps: int):
    """``examples/torch_train_lm.py``'s ``main(tiny=True)`` on the mesh,
    its output hidden: (losses, restarts, this rank's embedding shard
    shape)."""
    import contextlib
    import io
    from test_torch_world import example
    m = mesh(tuple(shape), tuple(axes))
    with contextlib.redirect_stdout(io.StringIO()):
        tr = example("torch_train_lm", dict(device="cpu", steps=steps,
                                            tiny=True, mesh=m,
                                            ckpt_dir=path))
    params, _ = tr.init_state()
    return ([h["loss"] for h in tr.history], tr.restarts,
            tuple(params["embed"].shape))


def tp_run(shape, axes, name: str, params: dict, batches: list, opt: dict,
           serve_kw: dict, over: dict | None = None):
    """The compute split on the mesh from the whole numpy ``params``:
    ``train``'s dict, plus the gradients of ``loss_fn`` at ``params`` on
    ``batches[0]`` gathered (``grads``), and greedy serving through
    ``launch.serve.serve`` on this rank's shards (``serve_kw``: batch,
    prompt_len, gen, seed): the tokens and the prefill step's last logits,
    gathered (``tokens``, ``logits``), and the shapes of this rank's cache
    leaves (``cache_shapes``).  ``over``: config fields replaced in the
    smoke config."""
    from repro_torch.configs import plan_for_mesh
    from repro_torch.data.pipeline import batch_spec, device_batch
    from repro_torch.launch.serve import serve, serve_inputs
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import loss_fn, param_defs, params_from_numpy
    from repro_torch.models.layers import specs_of
    from repro_torch.parallel.shard import (batch_rows, map_tree, set_mesh,
                                            shard_of, unshard)
    from repro_torch.train.optimizer import value_and_grad
    m = mesh(tuple(shape), tuple(axes))
    rm = _rm(shape, axes)
    cfg = _arch(name, **(over or {}))
    plan = plan_for_mesh(m)
    specs = specs_of(param_defs(cfg), plan)
    p = map_tree(lambda t, sp: shard_of(t, sp, rm),
                 params_from_numpy(params, "cpu"), specs)
    b = device_batch(batches[0], m, plan, grad_accum=cfg.grad_accum)
    with set_mesh(rm):
        _, _, g = value_and_grad(lambda pp, bb: loss_fn(pp, bb, cfg, plan),
                                 p, b)
    out = train(shape, axes, name, params, batches, opt, over)
    out["grads"] = _np(_gathered(g, specs, rm))
    tokens, _ = serve(cfg, m, plan, params=p, device="cpu", **serve_kw)
    inp = {k: batch_rows(v, batch_spec(k, v.shape, plan), rm)
           for k, v in serve_inputs(cfg, batch=serve_kw["batch"],
                                    prompt_len=serve_kw["prompt_len"],
                                    seed=serve_kw["seed"],
                                    device="cpu").items()}
    with set_mesh(rm):
        cache, logits = make_prefill_step(cfg, plan, serve_kw["prompt_len"],
                                          serve_kw["batch"])(p, inp)
    whole = (serve_kw["batch"],) + tuple(logits.shape[1:])
    out["logits"] = unshard(logits, plan.spec(("batch", None, None), whole),
                            rm).numpy()
    out["tokens"] = tokens.numpy()
    out["cache_shapes"] = _shapes(cache)
    return out


def seq_decode(shape, axes, name: str, params: dict, prompt, cache_len: int,
               feed):
    """Batch-1 serving on the mesh (``shape`` ``None``: one process, no
    mesh) from the whole numpy ``params``: ``prefill`` of ``prompt`` (1,
    P) into a cache of ``cache_len`` slots, then one ``decode_step`` for
    each token of ``feed`` (1, G) in turn.  Returns the last logits of the
    prefill and of every step (``logits``, (G + 1, V), whole), the cache
    gathered after the prefill and after the last step (``prefill_cache``,
    ``cache``), and the shapes of this rank's cache leaves
    (``cache_shapes``)."""
    import torch
    from repro_torch.configs import plan_for_mesh
    from repro_torch.launch.mesh import MeshSpec
    from repro_torch.models import (cache_defs, decode_step, param_defs,
                                    params_from_numpy, prefill)
    from repro_torch.models.layers import specs_of, tree_map
    from repro_torch.parallel.shard import map_tree, set_mesh, shard_of
    m = mesh(tuple(shape), tuple(axes)) if shape else None
    rm = _rm(shape, axes) if shape else None
    cfg = _arch(name)
    plan = plan_for_mesh(m if m is not None else MeshSpec.local())
    p = params_from_numpy(params, "cpu")
    cspecs = specs_of(cache_defs(cfg, 1, cache_len), plan)
    if rm is not None:
        p = map_tree(lambda t, sp: shard_of(t, sp, rm), p,
                     specs_of(param_defs(cfg), plan))

    def whole(cache):
        got = cache if rm is None else _gathered(cache, cspecs, rm)
        return tree_map(lambda a: a.copy(), _np(got))
    with torch.no_grad(), set_mesh(rm):
        cache, lg = prefill(p, {"tokens": torch.from_numpy(prompt)}, cfg,
                            plan, cache_len, global_batch=1)
        logits, first = [lg[0, -1].numpy().copy()], whole(cache)
        for i in range(feed.shape[1]):
            cache, lg = decode_step(p, cache, torch.from_numpy(
                feed[:, i:i + 1].copy()), cfg, plan, global_batch=1,
                cache_len=cache_len)
            logits.append(lg[0, -1].numpy().copy())
    return dict(logits=np.stack(logits), prefill_cache=first,
                cache=whole(cache), cache_shapes=_shapes(cache))


def tp_ops(shape, axes):
    """The region operators and a compute split's gather on the mesh, each
    ``model`` rank r weighting its share by r + 1: (``copy_to_model``'s
    gradient of ones, ``reduce_from_model`` of r + 1, a ``keep=2,
    summed`` gather of a (2, 8) leaf split over ``model`` and its
    gradient, a ``keep=1`` gather and its gradient, the coordinate)."""
    import torch
    from repro_torch.configs import plan_for_mesh
    from repro_torch.parallel.shard import (copy_to_model, gather,
                                            reduce_from_model, set_mesh,
                                            shard_of)
    m = mesh(tuple(shape), tuple(axes))
    rm = _rm(shape, axes)
    plan = plan_for_mesh(m)
    wgt = float(rm.coord["model"] + 1)
    x = torch.ones(3, requires_grad=True)
    whole = torch.arange(16, dtype=torch.float32).reshape(2, 8)
    spec = (None, "model")
    out = []
    with set_mesh(rm):
        (gx,) = torch.autograd.grad((copy_to_model(x) * wgt).sum(), [x])
        out += [gx.numpy(), reduce_from_model(torch.full((3,), wgt)).numpy()]
        for keep, summed in ((2, True), (1, False)):
            w = shard_of(whole, spec, rm).requires_grad_(True)
            got = gather(w, spec, plan, keep, summed)
            (gw,) = torch.autograd.grad((got * wgt).sum(), [w])
            out += [got.detach().numpy(), gw.numpy()]
    return (*out, dict(rm.coord))
