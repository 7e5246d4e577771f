"""Worlds of gloo ranks on the CPU for the port's sharded tests.

``World(n, path)`` spawns ``n`` processes that join one ``torch.distributed``
world (gloo, a ``file://`` store under ``path``: no TCP ports, so parallel
test workers cannot collide) and then serve calls: ``world.run(fn, *args)``
runs the module-level function ``fn(*args)`` on every rank at once and
returns the ranks' results in rank order.  A rank that raises, or a call
that outlasts its timeout, fails the call and ends the world (the next
call starts a new one), so one broken case cannot hang the suite.

The rank-side cases below import only ``repro_torch``; they take numpy
inputs and plain config dicts and return numpy arrays and python values.
"""
from __future__ import annotations

import multiprocessing
import queue
import traceback

import numpy as np

RANK_TIMEOUT_S = 60      # a collective that waits longer fails its rank
CALL_TIMEOUT_S = 120     # a call whose ranks take longer fails the test


class World:
    def __init__(self, n: int, path):
        self.n, self.path = n, path
        self._gen = 0
        self._procs = None

    def _start(self):
        ctx = multiprocessing.get_context("spawn")
        self._gen += 1
        init = f"file://{self.path}/store{self._gen}"
        self._in = [ctx.Queue() for _ in range(self.n)]
        self._out = ctx.Queue()
        self._procs = [ctx.Process(target=_serve, daemon=True,
                                   args=(r, self.n, init, self._in[r],
                                         self._out))
                       for r in range(self.n)]
        for p in self._procs:
            p.start()

    def run(self, fn, *args, timeout: float = CALL_TIMEOUT_S) -> list:
        if self._procs is None:
            self._start()
        for q in self._in:
            q.put((fn, args))
        got, errors = {}, []
        try:
            for _ in range(self.n):
                rank, ok, val = self._out.get(timeout=timeout)
                (got.__setitem__(rank, val) if ok else
                 errors.append(f"rank {rank}:\n{val}"))
        except queue.Empty:
            errors.append(f"{self.n - len(got) - len(errors)} ranks gave no "
                          f"result in {timeout} s")
        if errors:
            self.close()
            raise AssertionError("\n".join(errors))
        return [got[r] for r in range(self.n)]

    def close(self):
        if self._procs is None:
            return
        for q in self._in:
            q.put(None)
        for p in self._procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        self._procs = None


def _serve(rank: int, n: int, init: str, inq, outq):
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_world
    torch.set_num_threads(1)
    init_world("gloo", init, rank=rank, world_size=n,
               timeout_s=RANK_TIMEOUT_S)
    try:
        while True:
            try:
                job = inq.get()
                if job is None:
                    break
                fn, args = job
                outq.put((rank, True, fn(*args)))
            except Exception:
                outq.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------- rank-side cases --

_MESHES: dict = {}


def mesh(shape: tuple, axes: tuple):
    """This rank's ``DeviceMesh`` of a spec, built once per world (building
    one is a collective of every rank)."""
    from repro_torch.launch.mesh import MeshSpec
    key = (tuple(shape), tuple(axes))
    if key not in _MESHES:
        _MESHES[key] = MeshSpec(*key).build("cpu")
    return _MESHES[key]


def graph(name: str, args: tuple, seed: int | None = None):
    from repro_torch.core import rmat
    kw = {} if seed is None else dict(seed=seed)
    return getattr(rmat, name)(*args, **kw)


def _key(data):
    import torch
    return None if data is None else torch.from_numpy(
        np.asarray(data, dtype=np.int64))


def _pipeline_cfg(color: dict, recolor: dict, pipe: dict):
    import repro_torch.core as T
    return T.PipelineConfig(color=T.ColorConfig(**color),
                            recolor=T.RecolorConfig(**recolor), **pipe)


def build_errors(spec) -> list:
    """The errors of building ``spec`` for CUDA (on ranks without a GPU)
    and, on the CPU, with one rank more than the world has."""
    from repro_torch.launch.mesh import MeshSpec
    out = []
    for shape, device_type in ((spec[0], None),
                               ((spec[0][0] + 1,) + spec[0][1:], "cpu")):
        try:
            MeshSpec(shape, spec[1]).build(device_type)
            out.append("")
        except (RuntimeError, ValueError) as e:
            out.append(str(e))
    return out


def collectives(spec) -> dict:
    """``MeshComm``'s collectives on small tensors: each shard ``p`` of
    two lanes holds ``[[p, -p], [10 p, 1]]``."""
    import torch

    from repro_torch.core import MeshComm
    comm = MeshComm(mesh(*spec), lanes=2)
    p, P = comm.p, comm.P
    x = torch.tensor([[p, -p], [10 * p, 1]])
    ring = [(i, (i + 1) % P) for i in range(P)]
    return dict(
        p=p, psum=comm.psum(x).tolist(), pmax=comm.pmax(x).tolist(),
        pmin=comm.pmin(x).tolist(), any=comm.pmax(x > 5 * P).tolist(),
        gather=comm.all_gather(x.to(torch.int16)).tolist(),
        ppermute=comm.ppermute(x, ring).tolist(),
        index=comm.index().tolist(), lanes=comm.lane_uniform(p == 1))


def color(spec, g_spec, P, order, color: dict):
    """``color_graph_sharded``."""
    import repro_torch.core as T
    pg = T.partition_graph(graph(*g_spec), P)
    view, stats = T.color_graph_sharded(pg, order, T.ColorConfig(**color),
                                        mesh(*spec))
    return view.numpy(), stats


def color_then_recolor(spec, g_spec, P, order, color: dict, recolor: dict,
                       perm: str, key):
    """``color_graph_sharded``, then one ``recolor_sharded`` iteration of
    its view."""
    import repro_torch.core as T
    pg = T.partition_graph(graph(*g_spec), P)
    m = mesh(*spec)
    v1, s1 = T.color_graph_sharded(pg, order, T.ColorConfig(**color), m)
    v2, s2 = T.recolor_sharded(pg, v1, perm, T.RecolorConfig(**recolor), m,
                               key=_key(key))
    return v1.numpy(), s1, v2.numpy(), s2


def pipeline(spec, g_spec, P, halo, order, color: dict, recolor: dict,
             pipe: dict):
    """``pipeline_sharded``: the view and the result without its walls."""
    import repro_torch.core as T
    pg = T.partition_graph(graph(*g_spec), P, halo=halo)
    view, res = T.pipeline_sharded(pg, order,
                                   _pipeline_cfg(color, recolor, pipe),
                                   mesh(*spec))
    res.pop("seconds")
    return view.numpy(), res


def many(spec, g_specs, P, halo, color: dict, recolor: dict, pipe: dict,
         pad_batch: bool):
    """``color_many_sharded``: per graph its view, colors and stats."""
    import repro_torch.core as T
    pgs = [T.partition_graph(graph(*g), P, halo=halo) for g in g_specs]
    out = T.color_many_sharded(pgs, _pipeline_cfg(color, recolor, pipe),
                               mesh(*spec), pad_batch=pad_batch)
    return [dict(r, view=r["view"].numpy()) for r in out]


def serve(spec, P, g_specs, arrivals, cfg: dict, serve_kw: dict,
          prewarm: bool = False):
    """A ``FakeClock`` script through ``ColoringService`` on the mesh
    ``spec``, or (``spec=None``) on one device with the same config;
    ``prewarm`` runs each graph once first, so requests take the solo
    route.  Returns the shed and failed ids, the results and the stats."""
    from repro_torch.launch import serve_coloring as S
    from repro_torch.launch import serve_harness as H
    from repro_torch.core import program_cache_clear
    program_cache_clear()
    svc = S.ColoringService(
        P=P, cfg=S.default_config(**cfg), validate=True, device="cpu",
        mesh=None if spec is None else mesh(*spec), clock=S.FakeClock(),
        serve=S.ServeConfig(**serve_kw))
    graphs = [graph(*g) for g in g_specs]
    if prewarm:
        svc.prewarm(graphs)
    script = [H.Arrival(float(t), graphs[i]) for t, i in arrivals]
    out = H.run_script(svc, script)
    keep = ("colors", "n_colors", "color", "history", "n_iters_run", "route")
    return (sorted(out.shed), sorted(out.failed),
            {j: {k: r[k] for k in keep if k in r}
             for j, r in out.results.items()}, svc.stats())


def example(name: str, kw: dict):
    """``main(**kw)`` of ``examples/<name>.py`` on this rank."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parent.parent / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main(**kw)


def lm_plan(shape: tuple, axes: tuple) -> dict:
    """``configs.plan_for_mesh`` of this rank's ``DeviceMesh``, as a dict."""
    import dataclasses
    from repro_torch.configs import plan_for_mesh
    return dataclasses.asdict(plan_for_mesh(mesh(shape, axes)))


def ckpt_save(path: str, tree: dict, step: int) -> int:
    """Rank 0 saves ``tree`` (numpy leaves as tensors) at ``step``; every
    rank waits for it.  Returns the world's size."""
    import torch
    import torch.distributed as dist
    from repro_torch.models.layers import tree_map
    from repro_torch.train import checkpoint as ckpt
    if dist.get_rank() == 0:
        ckpt.save(path, step, tree_map(
            lambda a: torch.from_numpy(np.asarray(a)), tree))
    dist.barrier()
    return dist.get_world_size()


def ckpt_restore(path: str, specs: dict):
    """Restore the newest checkpoint onto this rank's ``(n,)`` ``data``
    mesh: (step, the tree as numpy, the leaves' devices), the tree
    gathered from the ranks' shards (the whole arrays, as ``np.asarray``
    of the reference's placed arrays gives them), and the shards' shapes."""
    import torch.distributed as dist
    from repro_torch.parallel.shard import RankMesh, unshard_tree
    from repro_torch.models.layers import flatten, tree_map
    from repro_torch.train import checkpoint as ckpt
    m = mesh((dist.get_world_size(),), ("data",))
    step, tree = ckpt.restore(path, mesh=m, specs=specs)
    devices = sorted({str(t.device) for t in flatten(tree).values()})
    whole = unshard_tree(tree, specs, RankMesh.of(m))
    return (step, tree_map(lambda t: t.numpy(), whole), devices,
            tree_map(lambda t: tuple(t.shape), tree))


def compressed_tree(grads_by_rank: list, errs_by_rank: list):
    """``compressed_psum_tree`` of this rank's gradients and errors over
    the world's ``(n,)`` ``data`` mesh; numpy (mean, new error)."""
    import torch
    import torch.distributed as dist
    from repro_torch.models.layers import tree_map
    from repro_torch.train.compression import compressed_psum_tree
    r = dist.get_rank()
    m = mesh((dist.get_world_size(),), ("data",))
    out, err = compressed_psum_tree(tree_map(torch.from_numpy,
                                             grads_by_rank[r]),
                                    tree_map(torch.from_numpy,
                                             errs_by_rank[r]), m)
    return tree_map(lambda t: t.numpy(), out), tree_map(lambda t: t.numpy(),
                                                        err)


def compressed_dp_train(steps: int, batch: int, seed: int) -> list:
    """The port's form of the reference's compressed DP train step test: a
    linear model, each rank on its shard of a global batch, int8 EF
    all-reduce, plain SGD at 0.1.  Returns the losses (the world's mean)."""
    import torch
    import torch.distributed as dist
    from repro_torch.train.compression import make_compressed_train_step
    n, r = dist.get_world_size(), dist.get_rank()

    def loss_fn(params, b):
        return torch.mean((b["x"] @ params["w"] - b["y"]) ** 2), {}

    def opt_update(params, grads, state):
        return ({k: p - 0.1 * grads[k] for k, p in params.items()}, state,
                {})

    step = make_compressed_train_step(loss_fn, opt_update,
                                      axis=mesh((n,), ("data",)))
    w_true = np.random.default_rng(0).normal(0, 1, (8, 1)).astype(np.float32)
    params = {"w": torch.zeros((8, 1))}
    err = {"w": torch.zeros((8, 1))}
    state: dict = {}
    g = np.random.default_rng(seed)
    losses = []
    per = batch // n
    for _ in range(steps):
        x = g.normal(0, 1, (batch, 8)).astype(np.float32)
        y = x @ w_true
        shard = {"x": torch.from_numpy(x[r * per:(r + 1) * per]),
                 "y": torch.from_numpy(y[r * per:(r + 1) * per])}
        params, state, err, info = step(params, state, err, shard)
        losses.append(float(info["loss"]))
    return losses
