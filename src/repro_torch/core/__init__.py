"""Distributed graph coloring with iterative recoloring — the PyTorch port.

All P shards run on one device as ``(P, …)`` tensors (``*_sim``), or one
shard per rank of a ``torch.distributed`` mesh (``*_sharded``,
``launch.mesh``).  Public API:

  Graph, PartitionedGraph, partition_graph      — graph substrate (numpy)
  pad_partition, bucket_graphs, GraphBucket      — batched shape buckets
  plan_fits, remap_plan_arrays                   — union round schedules
  IdPolicy, id_policy, check_int32_limits        — id-width policy
  to_device, arrays_from_numpy, view_from_numpy — host -> device state
  bucket_to_device                               — a bucket's lane batch
  compute_order                                  — vertex-visit orderings
  ColorConfig, color_graph_sim/_sharded,        — speculative coloring
  color_shards
  RecolorConfig, recolor_sim/_sharded,           — iterative recoloring
  recolor_shards
  recolor_iterations                             — ND-RAND%x schedules
  arc_sim, arc_shards                            — asynchronous recoloring
  PipelineConfig, pipeline_sim/_sharded          — color→recolor pipeline
  recolor_loop_sim                               — recolor-only loop
  color_many, color_many_sharded                 — batched multi-graph
                                                   pipeline (lanes)
  RecolorCarry, recolor_carry_init,              — the stepped recolor
  pipeline_carry, pipeline_step                    loop (serving engines)
  engine_init/step/put_program                   — the engines' cached
                                                   programs
  PlanSignature, plan_signature,                 — dispatch identity and
  bucket_signature, program_cache_*                the per-signature cache
  selection                                      — the strategy names and
                                                   their row-wise forms
  check_coloring, colors_from_views,             — validation
  assert_valid
  message_stats, MessageStats                    — piggybacking accounting
  stats_to_host                                  — device stats -> ints
  MeshComm, run_sharded, run_sharded_many        — the mesh executor
  shard_axis_of, batch_axis_of, batch_axis_size, — mesh axis-name contract
  mesh_axes
  presets.speed / presets.quality                — the paper's parameter sets
  select_colors, detect_conflicts                — the kernel entry points
  select_colors_d2, detect_conflicts_d2          — their distance-2 forms

Entry points take ``device=`` (default CUDA; ``"cpu"`` runs the plain
kernels) and import no jax.
"""
from repro_torch.kernels.ops import (detect_conflicts, detect_conflicts_d2,
                                     select_colors, select_colors_d2)

from . import ordering, presets, rmat, selection
from .comm import (ALLGATHER, AUTO, AXIS, BATCH_AXIS, SCHEME_CHOICES,
                   SCHEMES, SPARSE, AxisComm, CommConfig, MeshComm,
                   allgather_bytes_per_exchange, batch_axis_of,
                   batch_axis_size, mesh_axes, resolve_scheme, run_sharded,
                   run_sharded_many, shard_axis_of, stats_to_host)
from .graph import (CommPlan, Graph, GraphBucket, IdPolicy, PartitionedGraph,
                    arrays_from_numpy, bucket_graphs, bucket_to_device,
                    build_comm_plan, check_int32_limits, id_policy,
                    pad_partition, partition_graph, plan_fits,
                    remap_plan_arrays, to_device, view_from_numpy)
from .ordering import compute_order
from .piggyback import MessageStats, message_stats
from .pipeline import (HISTORY_STATS, PipelineConfig, PlanSignature,
                       RecolorCarry, bucket_signature, color_many,
                       color_many_sharded, color_then_recolor,
                       engine_init_program, engine_put_program,
                       engine_step_program, pipeline_carry,
                       pipeline_sharded, pipeline_sim, pipeline_step,
                       plan_signature, program_cache_clear,
                       program_cache_contains, program_cache_stats,
                       recolor_carry_init, recolor_lanes, recolor_loop,
                       recolor_loop_sim, resolve_pipeline_cfg)
from .recolor import (ND, NI, RAND, RV, RecolorConfig, arc_shards, arc_sim,
                      recolor_iterations, recolor_shards, recolor_sharded,
                      recolor_sim, schedule_for_iteration)
from .speculative import (ColorConfig, color_graph_sharded, color_graph_sim,
                          color_lanes, color_shards, resolve_cfg)
from .validate import assert_valid, check_coloring, colors_from_views

__all__ = [
    "ALLGATHER", "AUTO", "AXIS", "AxisComm", "BATCH_AXIS", "ColorConfig",
    "CommConfig", "CommPlan", "MeshComm",
    "Graph", "GraphBucket", "HISTORY_STATS", "IdPolicy", "MessageStats",
    "ND", "NI", "PartitionedGraph", "PipelineConfig", "PlanSignature",
    "RAND", "RV", "RecolorCarry", "RecolorConfig", "SCHEMES",
    "SCHEME_CHOICES", "SPARSE",
    "allgather_bytes_per_exchange", "arc_shards", "arc_sim",
    "arrays_from_numpy", "assert_valid", "batch_axis_of", "batch_axis_size",
    "bucket_graphs", "bucket_signature", "bucket_to_device",
    "build_comm_plan", "check_coloring", "check_int32_limits",
    "color_graph_sharded", "color_graph_sim", "color_lanes", "color_many",
    "color_many_sharded", "color_shards", "color_then_recolor",
    "colors_from_views", "compute_order", "detect_conflicts",
    "detect_conflicts_d2", "engine_init_program", "engine_put_program",
    "engine_step_program", "id_policy", "mesh_axes", "message_stats",
    "ordering", "pad_partition", "partition_graph", "pipeline_carry",
    "pipeline_sharded", "pipeline_sim", "pipeline_step", "plan_fits",
    "plan_signature", "presets", "program_cache_clear",
    "program_cache_contains", "program_cache_stats", "recolor_carry_init",
    "recolor_iterations",
    "recolor_lanes", "recolor_loop", "recolor_loop_sim", "recolor_shards",
    "recolor_sharded", "recolor_sim", "remap_plan_arrays", "resolve_cfg",
    "resolve_pipeline_cfg", "resolve_scheme", "rmat", "run_sharded",
    "run_sharded_many", "schedule_for_iteration", "select_colors",
    "select_colors_d2", "selection", "shard_axis_of", "stats_to_host",
    "to_device", "view_from_numpy",
]
