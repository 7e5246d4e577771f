"""The control of the check that decides ``correct``: the reference put in
the program's place with one guarantee broken, at a cell's own size.

    python3 colorbench/control.py --workload <name> --seeds 1,2,3

For each seed it makes the cell's graph, colors it with
``reference.control_coloring`` (each shard's next superstep of vertices
at once, First Fit at distance 1, no conflict ever repaired), recolors
that with the reference's K iterations, and judges the two colorings as a
run judges the program's.  Prints one JSON line a seed: the numbers, and
whether the run would be correct (it must not be).  Needs a CUDA card.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def control_numbers(config: dict, traffic: dict, seed: int, device) -> dict:
    """The numbers the check reads off the control's colorings."""
    from colorbench import graphs, reference
    mc = traffic["preset_args"]["max_colors"]
    indptr, indices = graphs.make_graph(config, seed, device)
    initial = reference.control_coloring(
        indptr, indices, config["shards"],
        traffic["preset_args"]["superstep"], mc)
    final = reference.recolor(initial, indptr, indices, traffic["n_iters"],
                              config["distance"], mc)
    return reference.judge(initial, final, indptr, indices,
                           distance=config["distance"],
                           n_iters=traffic["n_iters"], max_colors=mc)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds, e.g. 1,2,3")
    args = ap.parse_args(argv)
    here = Path(__file__).resolve().parent
    sys.path[:] = [str(ROOT)] + [p for p in sys.path
                                 if Path(p or ".").resolve() != here]
    import torch

    from colorbench import harness
    if not torch.cuda.is_available():
        print("the control runs on a CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(ROOT / "BENCHMARK.json", harness.BENCH_DIR,
                             args.workload, False)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        got = control_numbers(cell.config, cell.traffic, seed,
                              torch.device("cuda:0"))
        print(json.dumps({
            "workload": args.workload, "seed": seed, "numbers": got,
            "correct": all(v <= harness.LIMITS[k] for k, v in got.items()),
            "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
