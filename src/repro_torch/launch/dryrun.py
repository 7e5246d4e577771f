"""Coloring dry run: size the production coloring without running it.

The port's form of ``repro.launch.dryrun --coloring``: the same graph
(``rmat_er(18, 8, seed=1)``, 262144 vertices), partitioned over P = 256
(``pod16x16``) or 512 (``pod2x16x16``) shards with the same configs.
PyTorch has nothing to lower or compile, so the record holds what does
not come from HLO: the sparse schedule's ring rounds, the modeled and
padded bytes per exchange against the all-gather's, the int16 (wire16)
form of each, the ``scheme="auto"`` decision and plan signature, the 2D
``batch × shard`` mesh's axes, and the device bytes per rank
(``roofline.coloring_memory_projection`` with the partition's own
fractions).  One JSON per cell goes to ``--out``.  The LM cells
(``steps.input_specs``, ``dryrun_cell``) wait for the dry-run slice.

Usage::

    python -m repro_torch.launch.dryrun --coloring [--multi-pod |
        --both-meshes] [--out experiments/dryrun_torch] [--force]
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

from repro_torch.core import (ColorConfig, PipelineConfig, RecolorConfig,
                              allgather_bytes_per_exchange, partition_graph,
                              plan_signature, resolve_scheme, rmat)
from repro_torch.launch.mesh import MeshSpec
from repro_torch.roofline import projection_of

DEFAULT_OUT = "experiments/dryrun_torch"


def mesh_tag(multi_pod: bool) -> str:
    return "pod2x16x16" if multi_pod else "pod16x16"


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
    ap.add_argument("--coloring", action="store_true",
                    help="the coloring cells (the only ones ported)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    if not args.coloring:
        ap.error("only --coloring is ported; the LM cells (input_specs, "
                 "dryrun_cell) wait for the dry-run slice")
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    for mp in meshes:
        rec = dryrun_coloring(multi_pod=mp, out_dir=Path(args.out),
                              force=args.force)
        print(json.dumps(rec)[:240])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
