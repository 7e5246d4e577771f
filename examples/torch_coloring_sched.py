"""Coloring as a systems primitive on the PyTorch/CUDA port: conflict-free
microbatch scheduling.

The paper's motivating use (§1): concurrent procedures must not touch the
same resource.  Here a training batch whose samples update shared sparse
embedding rows: coloring the sample-conflict graph gives groups that can
be applied in parallel without write conflicts.  Part 2 is the serving
shape, a fresh conflict graph per step: ``schedule_many`` runs a batch of
graphs through ``core.color_many`` (shape buckets, one lane-batched run
per bucket).  The same steps as ``examples/coloring_sched.py``.

Run:  PYTHONPATH=src python examples/torch_coloring_sched.py [--device cpu]
"""
import argparse
import time

import numpy as np

from repro_torch.data.coloring_sched import (conflict_graph, schedule,
                                             schedule_many,
                                             validate_schedule)


def make_batch(rng, n_samples: int):
    """Each sample touches 4 of 4096 embedding rows; 25% also hit one of
    6 "hot" rows (the contention that forces serialization)."""
    rows = rng.integers(6, 4096, (n_samples, 4))
    hot = rng.random(n_samples) < 0.25
    rows[hot, 0] = rng.integers(0, 6, int(hot.sum()))
    return rows


def main(device=None, n_samples: int = 256, n_batches: int = 8,
         seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)

    # one batch, one conflict graph, one schedule
    rows = make_batch(rng, n_samples)
    g = conflict_graph(rows, n_samples)
    print(f"conflict graph: {n_samples} samples, {g.m} conflicting pairs, "
          f"maxdeg={g.max_degree}")
    groups, n_groups, log = schedule(rows, n_samples, n_workers=4,
                                     device=device)
    if not validate_schedule(rows, groups):
        raise RuntimeError("a group holds two conflicting samples")
    sizes = [len(gr) for gr in groups]
    print(f"schedule: {n_groups} conflict-free groups "
          f"(vs {n_samples} fully-serial steps) — sizes {sizes}")
    print(f"parallel speedup bound: {n_samples / n_groups:.1f}x, "
          f"largest group {max(sizes)} samples")

    # many batches at once: the batched pipeline
    batches = [make_batch(rng, n_samples) for _ in range(n_batches)]
    t0 = time.time()
    results = schedule_many(batches, n_samples, n_workers=4, n_iters=1,
                            device=device)
    dt = time.time() - t0
    for rows_b, (grp, _, _) in zip(batches, results):
        if not validate_schedule(rows_b, grp):
            raise RuntimeError("a group holds two conflicting samples")
    per_batch = [ng for _, ng, _ in results]
    print(f"schedule_many: {len(batches)} conflict graphs colored in one "
          f"batched dispatch ({dt:.2f}s) — groups per batch {per_batch}, "
          f"buckets used {sorted({s['bucket'] for _, _, s in results})}")
    return dict(rows=rows, single=(groups, n_groups, log), batches=batches,
                many=results)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="default CUDA; 'cpu' runs the plain kernels")
    main(device=ap.parse_args().device)
