"""Training launcher (the port of ``repro.launch.train``).

On the card:  python -m repro_torch.launch.train --arch qwen3-0.6b --steps 16
CPU-scale:    python -m repro_torch.launch.train --arch qwen3-0.6b --smoke \
                  --steps 200 --device cpu

On a mesh:   torchrun --nproc-per-node=8 -m repro_torch.launch.train \
                  --arch qwen3-0.6b --smoke --mesh 2x4 [--device cpu]

``--smoke`` uses the reduced same-family config; otherwise the full
published config.  In one process the model is whole on one device
(``MeshSpec.local()``; ``--production-mesh`` then names the reference's
16 x 16 layout for the plan only).  Under a world of more than one rank
(torchrun's environment, or a world the caller initialised) the ranks
build a mesh and each keeps its shards of the parameters, AdamW's state
and the batches (``parallel.shard``): ``--production-mesh`` trains on the
16 x 16 ``data × model`` layout (256 ranks), ``--mesh DxM`` on ``D × M``
ranks, and by default every rank is on ``data``.  NCCL on the GPUs, gloo
with ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import os

import torch.distributed as dist

from repro_torch.configs import get_arch, plan_for_mesh, smoke_of
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch.mesh import MeshSpec, init_world
from repro_torch.train import FailureInjector, OptConfig, Trainer, TrainerConfig


def build(argv=None) -> Trainer:
    """The ``Trainer`` of a command line (not yet run)."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--fail-at", type=int, nargs="*", default=[])
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--mesh", default=None,
                    help="DxM: the data x model layout of a world of D*M "
                         "ranks")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the CPU)")
    args = ap.parse_args(argv)

    arch = get_arch(args.arch)
    if args.smoke:
        arch = smoke_of(arch)
    mesh = _mesh(args)
    plan = plan_for_mesh(mesh)
    data = DataConfig(vocab_size=arch.vocab_size, seq_len=args.seq,
                      global_batch=args.batch)
    return Trainer(
        arch, mesh, plan, data,
        OptConfig(peak_lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                  total_steps=args.steps),
        TrainerConfig(num_steps=args.steps, ckpt_every=args.ckpt_every,
                      ckpt_dir=args.ckpt_dir, log_every=args.log_every),
        injector=FailureInjector(tuple(args.fail_at)) if args.fail_at
        else None, device=args.device)


def _mesh(args):
    """The ``MeshSpec`` of one process, or the built mesh of a world."""
    cpu = args.device == "cpu"
    if int(os.environ.get("WORLD_SIZE", "1")) > 1 and \
            not dist.is_initialized():
        init_world("gloo" if cpu else None)
    n = dist.get_world_size() if dist.is_initialized() else 1
    if n == 1:
        return MeshSpec.production() if args.production_mesh else \
            MeshSpec.local()
    if args.production_mesh:
        spec = MeshSpec.production()
    elif args.mesh:
        spec = MeshSpec.lm(*(int(x) for x in args.mesh.split("x")))
    else:
        spec = MeshSpec.lm(n, 1)
    return spec.build("cpu" if cpu else None)


def main(argv=None) -> Trainer:
    tr = build(argv)
    tr.run()
    for h in tr.history:
        print(json.dumps(h))
    print(f"# params={tr.arch.n_params():,} restarts={tr.restarts}")
    return tr


if __name__ == "__main__":
    main()
