"""Distributed graph coloring with iterative recoloring — the PyTorch port.

All P shards run on one device as ``(P, …)`` tensors.  Public API:

  Graph, PartitionedGraph, partition_graph      — graph substrate (numpy)
  to_device, arrays_from_numpy, view_from_numpy — host -> device state
  compute_order                                  — vertex-visit orderings
  ColorConfig, color_graph_sim, color_shards     — speculative coloring
  RecolorConfig, recolor_sim, recolor_shards     — iterative recoloring
  recolor_iterations                             — ND-RAND%x schedules
  arc_sim, arc_shards                            — asynchronous recoloring
  PipelineConfig, pipeline_sim                   — color→recolor pipeline
  recolor_loop_sim                               — recolor-only loop
  selection                                      — the strategy names and
                                                   their row-wise forms
  check_coloring, colors_from_views              — validation
  presets.speed / presets.quality                — the paper's parameter sets
  select_colors, detect_conflicts                — the kernel entry points
  select_colors_d2, detect_conflicts_d2          — their distance-2 forms

Entry points take ``device=`` (default CUDA; ``"cpu"`` runs the plain
kernels) and import no jax.
"""
from repro_torch.kernels.ops import (detect_conflicts, detect_conflicts_d2,
                                     select_colors, select_colors_d2)

from . import ordering, presets, rmat, selection
from .comm import (ALLGATHER, AUTO, SCHEME_CHOICES, SCHEMES, SPARSE,
                   CommConfig, resolve_scheme)
from .graph import (CommPlan, Graph, PartitionedGraph, arrays_from_numpy,
                    build_comm_plan, id_policy, partition_graph, to_device,
                    view_from_numpy)
from .ordering import compute_order
from .pipeline import (HISTORY_STATS, PipelineConfig, color_then_recolor,
                       pipeline_sim, recolor_loop, recolor_loop_sim,
                       resolve_pipeline_cfg)
from .recolor import (ND, NI, RAND, RV, RecolorConfig, arc_shards, arc_sim,
                      recolor_iterations, recolor_shards, recolor_sim,
                      schedule_for_iteration)
from .speculative import (ColorConfig, color_graph_sim, color_shards,
                          resolve_cfg)
from .validate import check_coloring, colors_from_views

__all__ = [
    "ALLGATHER", "AUTO", "ColorConfig", "CommConfig", "CommPlan", "Graph",
    "HISTORY_STATS", "ND", "NI", "PartitionedGraph", "PipelineConfig",
    "RAND", "RV", "RecolorConfig", "SCHEMES", "SCHEME_CHOICES", "SPARSE",
    "arc_shards", "arc_sim", "arrays_from_numpy", "build_comm_plan",
    "check_coloring",
    "color_graph_sim", "color_shards", "color_then_recolor",
    "colors_from_views", "compute_order", "detect_conflicts",
    "detect_conflicts_d2", "id_policy",
    "ordering", "partition_graph", "pipeline_sim", "presets",
    "recolor_iterations", "recolor_loop", "recolor_loop_sim",
    "recolor_shards", "recolor_sim", "resolve_cfg", "resolve_pipeline_cfg",
    "resolve_scheme", "rmat", "schedule_for_iteration", "select_colors",
    "select_colors_d2", "selection", "to_device", "view_from_numpy",
]
