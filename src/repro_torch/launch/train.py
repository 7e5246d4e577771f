"""Training launcher (the port of ``repro.launch.train``).

On the card:  python -m repro_torch.launch.train --arch qwen3-0.6b --steps 16
CPU-scale:    python -m repro_torch.launch.train --arch qwen3-0.6b --smoke \
                  --steps 200 --device cpu

``--smoke`` uses the reduced same-family config; otherwise the full
published config.  The model is one replica on one device
(``MeshSpec.local()``); ``--production-mesh`` names the reference's
16 x 16 layout for the sharding plan only (``plan_for_mesh`` of a
``MeshSpec``), the parameters stay whole on the device.
"""
from __future__ import annotations

import argparse
import json

from repro_torch.configs import get_arch, plan_for_mesh, smoke_of
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch.mesh import MeshSpec
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
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the CPU)")
    args = ap.parse_args(argv)

    arch = get_arch(args.arch)
    if args.smoke:
        arch = smoke_of(arch)
    mesh = MeshSpec.production() if args.production_mesh else \
        MeshSpec.local()
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


def main(argv=None) -> Trainer:
    tr = build(argv)
    tr.run()
    for h in tr.history:
        print(json.dumps(h))
    print(f"# params={tr.arch.n_params():,} restarts={tr.restarts}")
    return tr


if __name__ == "__main__":
    main()
