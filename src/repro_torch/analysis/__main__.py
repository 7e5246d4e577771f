"""The port's lint CLI: the SPMD-safety gate of ``src/repro_torch``.

Usage (from the repo root)::

    python -m repro_torch.analysis src/repro_torch            # AST rules
    python -m repro_torch.analysis src/repro_torch --audit    # + the
        collective audit on gloo worlds of 2 and 2 x 2 ranks (about 15 s)

Prints findings as ``path:line: [rule] message``.  Exit code 0: no finding
outside the baseline (``baseline.json`` beside this module, empty) and,
with ``--audit``, every audit check held; 1 otherwise.  Paths are taken
relative to the current directory.
"""
from __future__ import annotations

import argparse
import sys

from . import engine
from .findings import BASELINE


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("targets", nargs="*", default=["src/repro_torch"],
                    help="files or directories to lint")
    ap.add_argument("--audit", action="store_true",
                    help="also run the collective audit on gloo worlds")
    args = ap.parse_args(argv)

    res = engine.run_lint(args.targets, root=".", baseline=BASELINE)
    for f in res.findings:
        print(f.render())
    for e in res.errors:
        print(f"ERROR {e}", file=sys.stderr)
    counts = res.counts()
    summary = (" ".join(f"{k}={v}" for k, v in sorted(counts.items()))
               or "clean")
    print(f"repro-torch-lint: {res.n_files} files, {len(res.findings)} new "
          f"finding(s) [{summary}], {len(res.baselined)} baselined, "
          f"{res.suppressed} suppression(s)")
    failures: list = []
    if args.audit:
        from .collective_audit import run_audit
        audit = run_audit()
        print("\n".join(audit.summary_lines()))
        failures = audit.failures
    return 1 if (res.findings or res.errors or failures) else 0


if __name__ == "__main__":
    raise SystemExit(main())
