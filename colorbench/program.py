"""The system under test as the benchmark drives it: the PyTorch port
(``repro_torch``), and nothing else of it.

``Program`` partitions the benchmark's graph, moves it to the device once
and then solves it as often as it is asked, each time with a new key: the
speculative coloring (``speculative.color_lanes``) and then the
recoloring loop (``pipeline.recolor_loop``), the two calls that
``pipeline.color_then_recolor`` makes.  The harness calls them one by one
so that the traced run can span each, and so that the reference can judge
the coloring between them.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch import rng
from repro_torch.core import ordering, pipeline, presets, speculative
from repro_torch.core.graph import Graph, partition_graph, to_device


def pipeline_config(config: dict, traffic: dict) -> pipeline.PipelineConfig:
    """The traffic's preset with its recoloring budget, and the
    configuration's distance and coloring settings applied over it."""
    preset = getattr(presets, traffic["preset"])(**traffic["preset_args"])
    cfg = presets.pipeline_config(preset, n_iters=traffic["n_iters"],
                                  patience=traffic["patience"])
    dist = config["distance"]
    return dataclasses.replace(
        cfg,
        color=dataclasses.replace(cfg.color, distance=dist,
                                  **config.get("color_args", {})),
        recolor=dataclasses.replace(cfg.recolor, distance=dist))


def key(seed: int, i: int) -> torch.Tensor:
    """The key of solve ``i`` of a run with ``seed``."""
    return rng.fold_in(rng.key(seed), i)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Program:
    """One partitioned graph resident on ``device``, ready to solve."""

    def __init__(self, config: dict, traffic: dict, indptr: np.ndarray,
                 indices: np.ndarray, device):
        self.device = torch.device(device)
        preset = getattr(presets, traffic["preset"])(**traffic["preset_args"])
        g = Graph(n=len(indptr) - 1, indptr=indptr.astype(np.int64),
                  indices=indices.astype(np.int32))
        t = time.perf_counter()
        pg = partition_graph(g, config["shards"], halo=config["halo"])
        self.partition_s = time.perf_counter() - t
        order = ordering.compute_order(pg, preset.ordering)
        self.cfg = pipeline.resolve_pipeline_cfg(
            pg, pipeline_config(config, traffic))
        self.n_slots = pg.n_slots
        t = time.perf_counter()
        self.arrs = to_device(pg, self.device,
                              sparse=self.cfg.needs_sparse_plan)
        _sync(self.device)
        self.to_device_s = time.perf_counter() - t
        self.order = torch.as_tensor(order, device=self.device)

    def solve(self, k: torch.Tensor, span, on_initial=None):
        """Color and recolor once with key ``k``; returns the final ``(P,
        n_slots)`` view and the distinct-color count the program reports.
        ``span(name)`` wraps each stage; ``on_initial(view)`` sees the
        speculative view before the recoloring starts."""
        with span("color"):
            view, stats = speculative.color_lanes(self.arrs, self.order, k,
                                                  self.cfg.color)
        if on_initial is not None:
            on_initial(view)
        with span("recolor"):
            view, history, _ = pipeline.recolor_loop(self.arrs, view, k,
                                                     self.cfg)
        _sync(self.device)
        return view, (history[-1] if history else stats[0])[
            "n_colors_distinct"]
