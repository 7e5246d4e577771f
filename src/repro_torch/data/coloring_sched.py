"""Conflict-free scheduling via graph coloring — the paper's use case
(§1): "organizing computations so that no two concurrent procedures
access shared resources simultaneously".  The port's copy of
``repro.data.coloring_sched``.

In a training pipeline this appears when samples in a batch contend for
the same mutable resource — hot embedding rows updated sparsely,
per-expert buffers, feature hash buckets.  Build the conflict graph
(samples = vertices, shared resource = edge), color it, and each color
class becomes a microbatch whose updates are write-conflict-free.
``schedule_many`` colors a fresh conflict graph per step for many steps
at once through ``core.color_many``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import (color_many, colors_from_views,
                              partition_graph, presets)
from repro_torch.core.graph import Graph
from repro_torch.core.rmat import _edges_to_graph


def conflict_graph(resources: list[np.ndarray] | np.ndarray,
                   n_samples: int) -> Graph:
    """Samples sharing any resource id become adjacent.

    ``resources``: ``(n_samples, r)`` int array (or list of variable-length
    arrays) of the resource ids each sample touches.
    """
    if isinstance(resources, np.ndarray):
        resources = [resources[i] for i in range(resources.shape[0])]
    by_res: dict[int, list[int]] = {}
    for s, rs in enumerate(resources):
        for r in np.unique(rs):
            by_res.setdefault(int(r), []).append(s)
    src, dst = [], []
    for members in by_res.values():
        m = np.asarray(members)
        if len(m) < 2:
            continue
        # clique over samples sharing the resource
        i, j = np.triu_indices(len(m), k=1)
        src.append(m[i])
        dst.append(m[j])
    if not src:
        indptr = np.zeros(n_samples + 1, np.int64)
        return Graph(n_samples, indptr, np.zeros(0, np.int32))
    return _edges_to_graph(n_samples,
                           np.concatenate(src).astype(np.int32),
                           np.concatenate(dst).astype(np.int32))


def _groups(colors: np.ndarray) -> tuple[list, int]:
    """The sample ids of each color class, and the class count."""
    n_groups = int(colors.max(initial=0))
    groups = [np.nonzero(colors == c)[0] for c in range(1, n_groups + 1)]
    return groups, n_groups


def schedule(resources, n_samples: int, *, n_workers: int = 1,
             use_quality_preset: bool = True, seed: int = 0, device=None):
    """Color the conflict graph; return ``(groups, n_groups, stats)``.

    ``groups``: arrays of sample ids — each group is conflict-free and can
    be applied as one parallel microbatch.  ``device`` as every entry
    point (default CUDA).
    """
    g = conflict_graph(resources, n_samples)
    pg = partition_graph(g, n_workers, seed=seed)
    preset = presets.quality() if use_quality_preset else presets.speed()
    view, log = presets.run_preset(pg, preset, seed=seed, device=device)
    groups, n_groups = _groups(colors_from_views(pg, view.cpu().numpy()))
    return groups, n_groups, log


def schedule_many(batches, n_samples: int, *, n_workers: int = 1,
                  n_iters: int = 1, seed: int = 0, device=None):
    """Schedule many sample batches at once through ``core.color_many``.

    ``batches`` is a sequence of per-batch resource arrays (each as in
    ``schedule``); every batch's conflict graph is partitioned and the
    whole set runs bucketed, one lane-batched run per shape bucket, with
    power-of-two lane padding.  Returns one ``(groups, n_groups, stats)``
    triple per batch.
    """
    pgs = [partition_graph(conflict_graph(res, n_samples), n_workers,
                           seed=seed) for res in batches]
    preset = presets.quality(iters=n_iters)
    cfg = presets.pipeline_config(preset, seed=seed)
    out = []
    for r in color_many(pgs, cfg, orders=preset.ordering, pad_batch=True,
                        device=device):
        groups, n_groups = _groups(r["colors"])
        out.append((groups, n_groups, dict(color=r["color"],
                                           history=r["history"],
                                           bucket=r["bucket"])))
    return out


def validate_schedule(resources, groups) -> bool:
    """No two samples in a group share a resource."""
    if isinstance(resources, np.ndarray):
        resources = [resources[i] for i in range(resources.shape[0])]
    for grp in groups:
        seen: set[int] = set()
        for s in grp:
            rs = set(int(r) for r in np.unique(resources[int(s)]))
            if seen & rs:
                return False
            seen |= rs
    return True
