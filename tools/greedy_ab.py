"""Time the sequential kernels of a checkout on the GPU, for an A/B of two
trees.

    python3 tools/greedy_ab.py [--tree PATH]

PATH is a checkout of this repository (default: this one); its ``src/`` is
the package timed, so two trees are compared by running this script once
per tree, in turns (parent, change, change, parent), in one session on one
card.  The calls timed are round 0's first run of supersteps of
``chip_smoke.py``'s phases 7b and 7e (``rmat_good(20, 8, seed=1)`` on 64
shards and ``grid3d(32, 32, 32)`` with the two-hop halo on 16 shards, each
under First Fit and Least-Used), captured from the tree's own
``color_graph_sim``.  Each is timed as in ``chip_smoke.py``
(``greedy_readings``): five readings of 20 launches, by CUDA events and by
torch.profiler, with the L2 cache flushed before every launch and without.
Prints one line per call and the card's name and power limit; needs one
GPU, and exits 2 without one.
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", type=Path, default=ROOT,
                    help="checkout whose src/ is timed (default: this one)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("greedy_ab: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.tree.resolve() / "src"))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    import repro_torch.core as core
    from repro_torch.kernels import ops
    dev = torch.device(cs.DEVICE)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    g1 = core.rmat.rmat_good(cs.MAIN_SCALE, 8, seed=1)
    pg1 = core.partition_graph(g1, cs.MAIN_P)
    g2 = core.rmat.grid3d(*cs.D2_CROSS_GRID)
    pg2 = core.partition_graph(g2, cs.D2_P, halo=2)
    paths = ((1, pg1, core.compute_order(pg1, core.ordering.INTERNAL_FIRST)),
             (2, pg2, core.compute_order(pg2, core.ordering.INTERNAL_FIRST)))
    flush = torch.empty(cs.FLUSH_BYTES // 4, dtype=torch.int32, device=dev)
    for distance, pg, order in paths:
        for sel in (ops.FIRST_FIT, ops.LEAST_USED):
            cfg = core.ColorConfig(selection=sel, parallel_chunk=False,
                                   distance=distance)
            seen = cs.capture_greedy(core, ops, pg, order, cfg,
                                     dev)["round 0 first"]
            d2 = distance == 2
            view, _ = cs.greedy_call(ops, seen, d2, "cuda")
            per_shard = int((view != seen["view"]).sum()) / pg.P
            line = []
            name = "greedy_run_d2" if d2 else "greedy_run"
            for what, buf in (("flushed", flush), ("not flushed", None)):
                events = cs.greedy_readings(ops, seen, d2, buf)
                prof = [cs.device_ms(lambda: cs.greedy_call(
                    ops, seen, d2, "cuda", buf), cs.GREEDY_LAUNCHES, name)
                    for _ in range(cs.GREEDY_READINGS)]
                line.append(f"{what}: events {cs.spread_note(events)}; "
                            f"profiler {cs.spread_note(prof)}")
                if buf is not None:
                    ms = statistics.median(events)
            print(f"{args.tree} D{distance} {sel} ({per_shard:.1f} "
                  f"vertices per shard, {ms * 1e6 / per_shard:.1f} ns per "
                  f"vertex flushed): " + " | ".join(line), flush=True)
    print(f"profiler traces taken again for lost device events: "
          f"{len(cs.LOST_TRACES)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
