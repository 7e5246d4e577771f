"""Run one cell of the benchmark once, from the root of a checkout:

    python3 colorbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints the checks as its last lines on standard error and the result as
one JSON line, the last of standard output.  Exits with 2, printing no
result, without a CUDA card (or with fewer than the cell asks for), without
the program's package beside the benchmark, or when a module of JAX or of
the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    manifest = ROOT / "BENCHMARK.json"
    if not (ROOT / "src" / "repro_torch").is_dir() or not manifest.is_file():
        print(f"no program: {ROOT / 'src' / 'repro_torch'} or {manifest} "
              "is missing", file=sys.stderr)
        return 2
    # the benchmark's modules are imported as the package ``colorbench``,
    # never from the script's own folder (where they would shadow others)
    here = Path(__file__).resolve().parent
    sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
        p for p in sys.path if Path(p or ".").resolve() != here]
    import torch

    from colorbench import harness

    cell = harness.load_cell(manifest, harness.BENCH_DIR, args.workload,
                             bool(args.trace))
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell.chips:
        print(f"the cell needs {cell.chips} CUDA card(s); {cards} available",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              torch.device("cuda:0"), T_START)
    if result is None:
        return 2
    harness.print_result(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
