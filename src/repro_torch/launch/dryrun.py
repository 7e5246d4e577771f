"""Dry run: size each (architecture × shape × mesh) cell, and the
production coloring, without running them on a device.

**LM cells** (``dryrun_cell``; the reference's ``dryrun_cell``).  The
step of ``launch.steps.input_specs`` runs once on ``meta`` tensors at the
per-rank shapes of the first rank of the production mesh (``pod16x16``:
16 × 16 ``data × model``; ``pod2x16x16``: 2 × 16 × 16), so nothing is
allocated, under

- ``StepMeter``, one ``TorchDispatchMode`` that counts FLOPs per rank with
  ``torch.utils.flop_counter``'s registry (``FlopCounterMode``'s own
  counting functions, without its module tracking, which doubles the
  time of a cell), tracks live ``meta`` storages (the peak of live bytes
  per rank), and adds up the matmuls' operand and output bytes (the
  reference's HBM-traffic proxy);
- the dry mesh (``parallel.shard.RankMesh.dry``): every collective's count
  and per-rank output bytes by kind, nothing communicated.

The record keeps the reference's keys where they mean the same thing:
``status`` / ``reason`` (``shape_applicable``), ``n_chips``,
``memory_analysis`` (``argument_size_in_bytes``: the rank's shards;
``temp_size_in_bytes``: the peak of live bytes less the arguments;
``output_size_in_bytes``; ``alias_size_in_bytes``: outputs that are
arguments, the decode cache updated in place; ``total_per_device``: the
peak of live bytes, arguments included; ``fits`` within the H100's
80 GB), ``coll_count`` / ``coll_bytes``, ``roofline``
(``roofline.roofline_terms``, H100 SXM data-sheet peaks; its
``collective_s`` weighs the per-rank output bytes as the reference does,
so a reduce-scatter counts its output, 1/n of what it sends),
``coll_wire_bytes`` (the bytes a rank sends, by kind:
``parallel.shard.wire_bytes``), ``coll_shapes`` (the calls of each kind
by output shape), ``model_flops_global`` / ``_per_chip`` and
``useful_flops_ratio``, and ``seconds`` in place of ``lower_s`` /
``compile_s``.  What has no torch meaning is left out: the HLO text and
its size (``hlo_bytes``), the raw ``cost_analysis``, and
``dynamic_whiles`` (the port's loops are Python loops, each iteration
executed).  A decode cell says
``cache_seq_replicated``: whether its cache keeps whole a sequence dim
that the plan splits (batch 1, ``long_500k``).  It reads false: the
cache is placed by ``plan.spec`` of every dim (``steps.cache_specs``), and
decode attends over the split slots.  A cell that
runs past ``--limit`` seconds stops and is written with
``status="error"`` and the reason, as is any other failure.

**Coloring cells** (``--coloring``; the reference's ``dryrun --coloring``):
the same graph (``rmat_er(18, 8, seed=1)``, 262144 vertices), partitioned
over P = 256 (``pod16x16``) or 512 (``pod2x16x16``) shards with the same
configs.  PyTorch has nothing to lower or compile, so the record holds
what does not come from HLO: the sparse schedule's ring rounds, the
modeled and padded bytes per exchange against the all-gather's, the int16
(wire16) form of each, the ``scheme="auto"`` decision and plan signature,
the 2D ``batch × shard`` mesh's axes, and the device bytes per rank
(``roofline.coloring_memory_projection`` with the partition's own
fractions).

One JSON per cell goes to ``--out``.  Usage::

    python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes]
        [--jobs 8] [--limit 600] [--coloring] [--out DIR] [--force]
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import time
import traceback
import weakref
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import (SHAPES, get_arch, list_archs, plan_for_mesh,
                                 shape_applicable)
from repro_torch.core import (ColorConfig, PipelineConfig, RecolorConfig,
                              allgather_bytes_per_exchange, partition_graph,
                              plan_signature, resolve_scheme, rmat)
from repro_torch.launch.mesh import MeshSpec
from repro_torch.parallel.shard import RankMesh
from repro_torch.launch.steps import cache_specs, input_specs
from repro_torch.models import cache_defs
from repro_torch.models.layers import flatten
from repro_torch.roofline import (HBM_BYTES, model_flops, projection_of,
                                  roofline_terms)

DEFAULT_OUT = "experiments/dryrun_torch"


CELL_LIMIT_S = 600.0


def mesh_tag(multi_pod: bool) -> str:
    return "pod2x16x16" if multi_pod else "pod16x16"


# ----------------------------------------------------------- LM cells --

_aten = torch.ops.aten
MATMULS = {_aten.mm.default, _aten.bmm.default, _aten.addmm.default,
           _aten.baddbmm.default}


class StepMeter(TorchDispatchMode):
    """FLOPs (``flop_registry``), live bytes of the storages that tensors
    hold (each storage once, views and in-place results included; freed
    when its last tensor goes), their peak, and the matmuls' operand and
    output bytes.  Past ``deadline`` (a ``time.perf_counter`` reading) the
    next op raises ``TimeoutError``."""

    def __init__(self, deadline: float | None = None):
        super().__init__()
        self.deadline = deadline
        self.live = self.peak = self.mm_bytes = self.flops = 0
        self._refs: dict = {}

    def track(self, t: torch.Tensor) -> int:
        """Count ``t``'s storage as live; its bytes if it is new, else 0."""
        st = t.untyped_storage()
        key = st._cdata
        if key in self._refs:
            return 0
        nb = st.nbytes()
        self._refs[key] = weakref.ref(st, lambda _, k=key, n=nb:
                                      self._free(k, n))
        self.live += nb
        self.peak = max(self.peak, self.live)
        return nb

    def _free(self, key, nb: int) -> None:
        if self._refs.pop(key, None) is not None:
            self.live -= nb

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if self.deadline is not None and time.perf_counter() > self.deadline:
            raise TimeoutError("the cell ran past its time limit")
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        for t in outs:
            self.track(t)
        if func in MATMULS:
            self.mm_bytes += sum(t.numel() * t.element_size()
                                 for t in tree_leaves((args, outs))
                                 if isinstance(t, torch.Tensor))
        return out


def _storages(tree) -> dict:
    return {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
            for t in tree_leaves(tree) if isinstance(t, torch.Tensor)}


def measure(fn, args, rm: RankMesh, limit_s: float | None = None) -> dict:
    """Run ``fn(*args)`` once (``meta`` tensors; ``rm`` the dry mesh it
    runs on): FLOPs, bytes and collectives per rank."""
    meter = StepMeter(None if limit_s is None
                      else time.perf_counter() + limit_s)
    arg_st = _storages(args)
    for t in tree_leaves(args):
        if isinstance(t, torch.Tensor):
            meter.track(t)
    with meter:
        out = fn(*args)
    out_st = _storages(out)
    arg_b = sum(arg_st.values())
    alias = sum(n for k, n in out_st.items() if k in arg_st)
    return dict(
        flops=float(meter.flops), mm_bytes=float(meter.mm_bytes),
        argument_size_in_bytes=arg_b,
        temp_size_in_bytes=meter.peak - arg_b,
        output_size_in_bytes=sum(out_st.values()),
        alias_size_in_bytes=alias, total_per_device=meter.peak,
        coll_count=dict(rm.log.count), coll_bytes=dict(rm.log.bytes),
        coll_wire_bytes=dict(rm.log.wire), coll_shapes=_shapes(rm.log))


def _shapes(log) -> dict:
    """Per kind, the count of calls by output shape (``"(16, 4096,
    1024)"``)."""
    out: dict = {}
    for op, _, shape in log.calls:
        by = out.setdefault(op, {})
        by[str(shape)] = by.get(str(shape), 0) + 1
    return out


def _cache_seq_replicated(arch, shape, plan) -> bool:
    """Whether the cell's cache (``steps.cache_specs``) keeps whole a
    sequence dim that ``plan.spec`` splits."""
    cdefs = cache_defs(arch, shape.global_batch, shape.seq_len)
    placed = flatten(cache_specs(cdefs, plan))
    for k, d in flatten(cdefs).items():
        if "seq" in d.dims:
            i = d.dims.index("seq")
            if plan.spec(d.dims, d.shape)[i] is not None and \
                    placed[k][i] is None:
                return True
    return False


def lm_record(arch, shape, spec: MeshSpec,
              limit_s: float | None = CELL_LIMIT_S) -> dict:
    """The dry-run record of one step of ``arch`` on ``shape`` at the
    per-rank shapes of ``spec``'s first rank (``status`` ``ok``, or
    ``error`` with the reason)."""
    rm = RankMesh.dry(spec)
    n_chips = rm.n_ranks
    rec: dict = dict(status="error", n_chips=n_chips)
    t0 = time.perf_counter()
    try:
        fn, args = input_specs(arch, shape, rm)
        m = measure(fn, args, rm, limit_s)
    except Exception as e:
        rec.update(error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:],
                   seconds=round(time.perf_counter() - t0, 3))
        return rec
    terms = roofline_terms(m["flops"], m["mm_bytes"], m["coll_bytes"])
    mf = model_flops(arch, shape)
    ma = {k: m[k] for k in ("argument_size_in_bytes", "temp_size_in_bytes",
                            "output_size_in_bytes", "alias_size_in_bytes",
                            "total_per_device")}
    ma["fits"] = ma["total_per_device"] <= HBM_BYTES
    rec.update(status="ok", seconds=round(time.perf_counter() - t0, 3),
               memory_analysis=ma, coll_count=m["coll_count"],
               coll_bytes=m["coll_bytes"],
               coll_wire_bytes=m["coll_wire_bytes"],
               coll_shapes=m["coll_shapes"], roofline=terms,
               model_flops_global=mf, model_flops_per_chip=mf / n_chips,
               useful_flops_ratio=(mf / n_chips) / terms["flops"]
               if terms["flops"] else 0.0)
    if shape.kind == "decode":
        rec["cache_seq_replicated"] = _cache_seq_replicated(
            arch, shape, plan_for_mesh(spec))
    return rec


def dryrun_cell(arch_name: str, shape_name: str, *, multi_pod: bool,
                out_dir: Path, force: bool = False,
                limit_s: float | None = CELL_LIMIT_S) -> dict:
    """Write (or read back) the record of one cell."""
    tag = f"{arch_name}__{shape_name}__{mesh_tag(multi_pod)}"
    out_path = Path(out_dir) / f"{tag}.json"
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())
    arch = get_arch(arch_name)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(arch, shape)
    rec: dict = dict(arch=arch_name, shape=shape_name,
                     mesh=mesh_tag(multi_pod), status="skipped", reason=why)
    if ok:
        rec.update(lm_record(arch, shape,
                             MeshSpec.production(multi_pod=multi_pod),
                             limit_s))
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(rec, indent=1))
    return rec


def _cell_line(rec: dict) -> str:
    extra = ""
    if rec.get("status") == "ok":
        r = rec["roofline"]
        extra = (f"dom={r['bottleneck']} c={r['compute_s']:.3f}s "
                 f"m={r['memory_s']:.3f}s x={r['collective_s']:.3f}s "
                 f"peak={rec['memory_analysis']['total_per_device'] / 2**30:.2f}GiB")
    elif rec.get("status") == "error":
        extra = rec.get("error", "")[:120]
    return (f"[{rec.get('seconds', 0.0):7.1f}s] {rec['arch']:22s} "
            f"{rec['shape']:12s} {rec['mesh']:10s} {rec['status']:8s} "
            f"{extra}")


def _run_cell(job) -> dict:
    arch, shape, mp, out_dir, force, limit_s = job
    return dryrun_cell(arch, shape, multi_pod=mp, out_dir=Path(out_dir),
                       force=force, limit_s=limit_s)


def _exchange_bytes(pg, itemsize: int) -> dict:
    plan = pg.comm_plan
    return dict(
        modeled_bytes_per_exchange=plan.bytes_per_exchange(itemsize),
        padded_bytes_per_exchange=plan.bytes_per_exchange(itemsize,
                                                          padded=True),
        allgather_modeled_bytes_per_exchange=allgather_bytes_per_exchange(
            pg.P, pg.max_boundary, itemsize))


def coloring_record(scale: int, P: int, batch: int = 2) -> dict:
    """The dry-run record of ``rmat_er(scale, 8, seed=1)`` on P shards
    (``batch``: the 2D mesh's batch axis)."""
    t0 = time.perf_counter()
    g = rmat.rmat_er(scale, 8, seed=1)
    pg = partition_graph(g, P)
    plan = pg.comm_plan
    sig = plan_signature(pg, PipelineConfig(
        color=ColorConfig(max_colors=256, superstep=64, scheme="auto"),
        recolor=RecolorConfig(max_colors=256, scheme="auto"),
        n_iters=4, patience=2))
    sparse = dict(n_rounds=len(plan.shifts), **_exchange_bytes(pg, 4),
                  scheme_decision=resolve_scheme("auto", pg),
                  plan_signature=sig.describe())
    mesh2d = MeshSpec.coloring(P, batch=batch)
    return dict(
        arch="coloring", shape=f"rmat{scale}_P{P}", status="ok",
        n_chips=P, seconds=round(time.perf_counter() - t0, 3),
        graph=dict(n=g.n, m=g.m, P=P, n_local_max=pg.n_local_max,
                   max_boundary=pg.max_boundary, max_ghost=pg.max_ghost,
                   max_send=plan.max_send),
        sparse=sparse, wire16=_exchange_bytes(pg, 2),
        mesh2d=dict(axes=[[n, s] for n, s in zip(mesh2d.axes,
                                                 mesh2d.shape)],
                    batch_lanes=2),
        projection=dict(allgather=projection_of(pg),
                        sparse=projection_of(pg, sparse=True),
                        batched=projection_of(pg, batch=2)))


def dryrun_coloring(*, multi_pod: bool, out_dir: Path,
                    force: bool = False) -> dict:
    """Write (or read back) the coloring cell of one mesh: P = 512 on the
    multi-pod mesh, 256 otherwise."""
    P = 512 if multi_pod else 256
    out_path = Path(out_dir) / f"coloring__rmat18__{mesh_tag(multi_pod)}.json"
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())
    rec = coloring_record(18, P, batch=1 if multi_pod else 2)
    rec["mesh"] = mesh_tag(multi_pod)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(rec, indent=1))
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--coloring", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--limit", type=float, default=CELL_LIMIT_S,
                    help="seconds a cell may run before it is an error")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells run in this many processes at once")
    args = ap.parse_args(argv)
    out_dir = Path(args.out)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    if args.coloring:
        for mp in meshes:
            rec = dryrun_coloring(multi_pod=mp, out_dir=out_dir,
                                  force=args.force)
            print(json.dumps(rec)[:240])
        if not (args.all or args.arch):
            return 0
    archs = list_archs() if args.all or not args.arch else [args.arch]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]
    jobs = [(a, s, mp, str(out_dir), args.force, args.limit)
            for a in archs for s in shapes for mp in meshes]
    if args.jobs <= 1:
        for job in jobs:
            print(_cell_line(_run_cell(job)), flush=True)
        return 0
    with multiprocessing.get_context("spawn").Pool(args.jobs) as pool:
        for rec in pool.imap_unordered(_run_cell, jobs):
            print(_cell_line(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
