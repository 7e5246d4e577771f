"""The color→recolor pipeline: speculative coloring, then K recoloring
iterations with an adaptive stop, all shards on one device.

The reference's fused ``repro.core.pipeline`` (one ``lax.while_loop``)
becomes a Python loop over device-resident state.  Each iteration reads
the device once (its chunk schedule, ``recolor.recolor_schedule``); that
read also carries the class count of the view the previous iteration
produced, which is exactly the previous iteration's distinct-color count,
so the ``patience`` stop is decided without a further read.  The
per-iteration stats (the ``HISTORY_STATS`` columns) cross to the host
once, at the end.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch import rng

from .comm import AUTO, SPARSE, make_exchange, sparse_rounds
from .graph import PartitionedGraph, to_device
from .recolor import (ALL_PERMS, INT32_MAX, ND, PERM_IDS, RecolorConfig,
                      class_sizes, permutation_rank,
                      recolor_schedule, recolor_steps,
                      schedule_for_iteration)
from .speculative import (ColorConfig, apply_partial, color_shards,
                          resolve_cfg, resolve_device)

# Column layout of the per-iteration history (the reference's order).
# ``ran`` marks rows the adaptive stop reached.
HISTORY_STATS = ("n_colors", "n_colors_distinct", "n_colors_before",
                 "n_exchanges", "n_steps", "wire_bytes", "n_out_of_range",
                 "perm_id", "ran")


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Static configuration of the color→recolor pipeline.

    ``n_iters`` (K) caps the recoloring iterations; ``patience`` (in
    iterations, 0 = off) stops once the global distinct-color count has
    not improved for that many iterations.  One device layout serves both
    stages, so ``color`` and ``recolor`` must agree on ``distance``.
    """

    color: ColorConfig | None = None
    recolor: RecolorConfig = RecolorConfig()
    n_iters: int = 8               # K — max recoloring iterations
    base_perm: str = ND            # schedule base (paper's best: ND)
    rand_every: int = 0            # ND-RAND%x: RAND every x-th iteration
    rand_pow2: bool = False        # ND-RAND%2^i: RAND at power-of-two its
    patience: int = 0              # adaptive stop (0 = run all K)
    seed: int = 0                  # recoloring key seed (folded per it)

    def __post_init__(self):
        if self.n_iters < 0 or self.patience < 0:
            raise ValueError("n_iters and patience must be >= 0")
        if self.base_perm not in ALL_PERMS:
            raise ValueError(f"bad perm {self.base_perm!r}")
        if (self.color is not None
                and self.color.distance != self.recolor.distance):
            raise ValueError("one device layout serves both stages: color "
                             "and recolor must agree on distance")

    @property
    def kind_ids(self) -> tuple:
        """Per-iteration permutation ids (the ND-RAND%x schedule)."""
        return tuple(
            PERM_IDS[schedule_for_iteration(it, self.base_perm,
                                            self.rand_every, self.rand_pow2)]
            for it in range(1, self.n_iters + 1))

    @property
    def needs_sparse_plan(self) -> bool:
        return (self.recolor.scheme == SPARSE
                or (self.color is not None and self.color.scheme == SPARSE))


def recolor_loop(arrs: dict, view: torch.Tensor, key, cfg: PipelineConfig):
    """K recoloring iterations with the adaptive stop (all shards).

    Returns ``(view, history rows, n_iters_run)``; each history row is a
    pair (device tensor of ``n_colors``, ``n_colors_distinct``,
    ``n_out_of_range``; host dict of the rest).
    """
    rcfg = cfg.recolor
    if rcfg.scheme == AUTO:
        raise ValueError("scheme='auto' must be resolved by an entry point "
                         "(resolve_pipeline_cfg) before the run")
    n_local_max = arrs["indptr"].shape[1] - 1
    K = cfg.n_iters
    patience = cfg.patience if cfg.patience else K + 1   # K+1 never trips
    exchange = make_exchange(arrs, rcfg.comm_config)
    n_rounds = sparse_rounds(arrs)
    sizes, n_oor = class_sizes(view, arrs["n_local"], n_local_max,
                               rcfg.max_colors)
    best, stall, rows = INT32_MAX, 0, []
    it = 1
    while it <= K:
        kind_id = cfg.kind_ids[it - 1]
        n_classes = (sizes > 0).sum()
        rank = permutation_rank(sizes, ALL_PERMS[kind_id],
                                rng.fold_in(key, it))
        sched = recolor_schedule(arrs, view, rank, n_classes, rcfg, n_rounds)
        if it > 1:
            # this class count is the previous iteration's distinct colors
            improved = sched.n_classes < best
            best = min(best, sched.n_classes)
            stall = 0 if improved else stall + 1
            if stall >= patience:
                break
        view, st = recolor_steps(arrs, sched, exchange, rcfg)
        sizes, oor_next = class_sizes(view, arrs["n_local"], n_local_max,
                                      rcfg.max_colors)
        dev_part = torch.stack([st["n_colors"].long(),
                                (sizes > 0).sum(), n_oor.long()])
        rows.append((dev_part, dict(
            n_colors_before=st["n_colors_before"],
            n_exchanges=st["n_exchanges"], n_steps=st["n_steps"],
            wire_bytes=st["wire_bytes"], perm_id=kind_id)))
        n_oor = oor_next
        it += 1
    return view, rows, it - 1


def color_then_recolor(arrs: dict, order: torch.Tensor, color_key,
                       recolor_key, cfg: PipelineConfig):
    """Initial speculative coloring + K recoloring iterations.

    Returns ``(view, color_stats, history rows, n_iters_run)``.
    """
    if cfg.color is None:
        raise ValueError("color_then_recolor needs cfg.color")
    view, cstats = color_shards(arrs, order, color_key, cfg.color)
    view, rows, n_run = recolor_loop(arrs, view, recolor_key, cfg)
    return view, cstats, rows, n_run


def _history_to_host(rows) -> list[dict]:
    """History rows -> one dict per executed iteration, with one
    device->host transfer for all device parts."""
    if not rows:
        return []
    dev = torch.stack([d for d, _ in rows]).tolist()
    out = []
    for i, ((n_colors, nd, oor), (_, host)) in enumerate(zip(dev, rows)):
        vals = dict(host, n_colors=n_colors, n_colors_distinct=nd,
                    n_out_of_range=oor, ran=1)
        row = {k: vals[k] for k in HISTORY_STATS if k != "ran"}
        row["perm"] = ALL_PERMS[row.pop("perm_id")]
        row["iteration"] = i + 1
        out.append(row)
    return out


def resolve_pipeline_cfg(pg: PartitionedGraph,
                         cfg: PipelineConfig) -> PipelineConfig:
    """Concretize any ``scheme="auto"`` stage against ``pg``'s comm plan."""
    return dataclasses.replace(
        cfg, color=None if cfg.color is None else resolve_cfg(pg, cfg.color),
        recolor=resolve_cfg(pg, cfg.recolor))


def recolor_loop_sim(pg: PartitionedGraph, view, cfg: PipelineConfig,
                     key=None, *, device=None):
    """The recolor-only loop of ``pg`` on one device (``cfg.color`` is not
    used): K iterations from the coloring ``view`` with the adaptive stop,
    ``recolor_iterations``' default path.

    ``key`` defaults to ``rng.key(cfg.seed)``; iteration ``it`` uses
    ``fold_in(key, it)``.  Returns ``(view, history, n_iters_run)``.
    """
    device = resolve_device(device)
    cfg = resolve_pipeline_cfg(pg, cfg)
    arrs = to_device(pg, device, sparse=cfg.needs_sparse_plan)
    view, rows, n_run = recolor_loop(
        arrs, torch.as_tensor(view, device=device),
        rng.key(cfg.seed) if key is None else key, cfg)
    return view, _history_to_host(rows), n_run


def pipeline_sim(pg: PartitionedGraph, order, cfg: PipelineConfig, *,
                 marked=None, color_key=None, recolor_key=None, device=None):
    """Run the color→recolor pipeline of ``pg`` on one device.

    ``order``/``marked`` as ``color_graph_sim``; ``color_key`` /
    ``recolor_key`` default to ``rng.key(cfg.color.seed)`` /
    ``rng.key(cfg.seed)``; ``device`` defaults to CUDA (``"cpu"`` runs the
    plain kernels on the CPU).
    Returns ``(view, result)``: the final ``(P, n_slots)`` view and
    ``result`` with the initial-coloring stats (``"color"``), one history
    dict per executed iteration (``"history"``), ``"n_iters_run"`` and
    the wall ``"seconds"`` of each stage (``to_device``, ``color``,
    ``recolor``).
    """
    if cfg.color is None:
        raise ValueError("pipeline_sim needs cfg.color")
    device = resolve_device(device)
    cfg = resolve_pipeline_cfg(pg, cfg)
    order = apply_partial(order, cfg.color, marked)
    ck = rng.key(cfg.color.seed) if color_key is None else color_key
    rk = rng.key(cfg.seed) if recolor_key is None else recolor_key
    # every stage ends in a device->host read, so host clocks at the stage
    # boundaries time the device work too
    t0 = time.perf_counter()
    arrs = to_device(pg, device, sparse=cfg.needs_sparse_plan)
    order = torch.as_tensor(order, device=device)
    t1 = time.perf_counter()
    view, cstats = color_shards(arrs, order, ck, cfg.color)
    t2 = time.perf_counter()
    view, rows, n_run = recolor_loop(arrs, view, rk, cfg)
    history = _history_to_host(rows)
    t3 = time.perf_counter()
    return view, dict(color=cstats, history=history, n_iters_run=n_run,
                      seconds=dict(to_device=t1 - t0, color=t2 - t1,
                                   recolor=t3 - t2))

