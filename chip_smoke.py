"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (each prints one line with its seconds; any failure exits nonzero
before the final line):

1. card and build — the ``nvidia-smi`` name/power-limit query, then the
   hand-written CUDA kernels built with ``nvcc`` from ``src/repro_torch``;
2. kernels against their plain PyTorch versions on the card — random
   tiles with out-of-range colors, a batched (B, V, D) tile, the
   saturation rows, and the main-path shapes (distance 1: speculative
   tiles 64x128 rows, recolor chunks 64x256 rows, conflict chunks 64x512
   rows, MAXD=678; distance 2: speculative tiles 16x16 rows, recolor
   chunks 16x256 rows, conflict chunks 16x512 rows, MAXD=26 + MAXD2=98,
   the rows whose taken colors are split between the one-hop and the
   two-hop tile; max_colors=1024); bitwise equal, with each kernel's
   device time per launch (torch.profiler), the plain version's device
   time per call, the bytes bound, and the wrapper's call time (CUDA
   events around the Python call, host-bound on small tiles);
3. the main path at full size — ``rmat_good(20, 8, seed=1)`` on P=64
   shards, the "quality" preset (Random-X X=10, Internal-First, ND
   recoloring) with K=8 iterations, through ``pipeline_sim`` on the GPU; the
   coloring must be valid, the run kernel ``select_run`` and the frontier
   kernel ``conflict_frontier`` must have launched and the tile-form
   select and conflict kernels must not (all eight counted in this run);
   then (phase 3b) the run kernel against its plain version on this
   path's own arrays — the middle superstep of round 0 (64 shards x 4
   Random-X tiles of 128 rows) and the largest class of an ND iteration
   from the final coloring (256-row chunks) — and the frontier kernel
   against its plain version on the arguments of the path's own first
   repair (round 0's pre-repair view, as its supersteps and boundary
   exchanges left it, taken from one more run that ends there), bitwise,
   each with its time per launch by CUDA events (five readings of 20
   launches, the L2 cache flushed before each, as phase 7 times the
   sequential kernels; the profiler's reading beside it), the device
   time of the plain version and of the unfused sequence it replaced
   (ELL gathers + the tile kernel + the scatters, per tile or superstep
   chunk), and the bytes bound of the work this run's data needs; then
   (phase 3c) ``exchange_push`` against its plain version on the path's
   own recoloring exchange and one ND iteration's schedule of its final
   coloring, every push of the iteration, plain, with wire16 and with a
   frozen lane, bitwise, timed by CUDA events (L2 flushed) against its
   bytes bound (its launches are counted in the main-path run); then
   the same path
   ``WARM_RUNS`` times more, warm and unprofiled (their median stage
   walls), and once under ``torch.profiler`` for the device-time
   breakdown and the operators that launched it;
4. cross-check — ``rmat_good(18, 8, seed=2)`` at P=16 with the kernels and
   with ``backend="torch"``, under the sparse and all-gather exchanges:
   views, color stats and histories bitwise equal (the wire bytes differ
   between the schemes by design; the padding of unused ghost slots, which
   no vertex reads, differs between the schemes too);
5. the distance-2 path at full size — ``grid3d(64, 64, 64)`` (the 27-point
   stencil, HPCG's operator pattern) partitioned with the two-hop halo on
   P=16 shards, the "quality" preset with K=8 and ``distance=2``,
   ``tile=16`` on both stages, through ``pipeline_sim`` on the GPU; the
   coloring must be valid at distance 2, ``select_run_d2`` and
   ``conflict_frontier_d2`` must have launched and the tile-form select
   and conflict kernels must not (counted in this run); then (phase 5b)
   ``select_run_d2`` and ``conflict_frontier_d2`` against their plain
   versions as in phase 3b (16 shards x 32 tiles of 16 rows; the largest
   class in 256-row chunks; round 0's repair), ``exchange_push`` as in
   phase 3c (phase 5c); then the warm and profiled repeats;
6. distance-2 cross-check — ``grid3d(32, 32, 32)`` at P=16, K=4: kernels
   vs plain under both exchanges, then partial D2 of the even global ids,
   kernels vs plain; bitwise equal, unmarked vertices left uncolored;
7. the paper's variant paths, on phase 3's graph, partition and order
   and phase 6's: (a) ``pipeline_sim`` under ND-RAND%2^i (the quality
   preset, K=8, RAND at iterations 2, 4 and 8): valid, the color count
   never rising from one iteration to the next; (b) the sequential
   superstep coloring through ``color_graph_sim``, First Fit with
   ``parallel_chunk=False`` and then Least-Used: valid, ``greedy_run``
   launched and ``select_run`` not (counted per run), with the warm
   color stage's median wall; (c) ``arc_sim`` with the RAND rank of phase
   3's coloring: valid; (d) ``greedy_run`` in both instantiations (the
   local colors in shared memory, as the shapes choose, and in device
   memory, under a lowered budget) against its plain version on three of
   each (b) run's own runs of supersteps (``capture_greedy``: round 0's
   first and middle, round 1's first), view and usage bitwise, and First
   Fit also against ``select_run`` at ``tile=1``; on round 0's first the
   time per launch by CUDA events (five readings of 20 launches with the
   L2 cache flushed before every launch, five without, five of the
   device-memory form), the card's clock and power beside them, the
   time per vertex and the bytes bound; (e) the sequential coloring at
   distance 2 (First Fit and Least-Used) on phase 6's partition: valid at
   distance 2, bitwise equal to the plain coloring, ``greedy_run_d2`` as
   in (d);
8. batched multi-graph coloring at full size through ``color_many``
   (``pad_batch=True``): 8 x ``rmat_good(17, 8)`` and 4 x
   ``rmat_bad(17, 8)`` on P=16 (two shape buckets, as many edges in all
   as phase 3's graph), the quality preset with K=8, and a distance-2
   bucket of phase 6's ``grid3d(32, 32, 32)`` partition and
   ``grid3d(32, 32, 24)`` (halo 2, P=16), the D2 preset with K=8.  Per
   bucket: a counted cold run (its launches), every lane valid at its
   distance and bitwise equal to a counted solo ``pipeline_sim`` of its
   padded member on the card, fewer launches of the path's kernels than
   the solo runs together (B >= 2), the warm median wall against the
   solo stage walls together, the warm device idle share, peak device
   memory; then the lane forms of ``conflict_frontier[_d2]`` (per-lane
   counts) and of the recolor mode of ``select_run[_d2]`` (per-lane
   ``class_chunks``) against their plain versions on the bucket's own
   first repair and its largest recolor run, bitwise, timed by CUDA
   events;
9. the continuous-batching service (``repro_torch.launch.serve_coloring``,
   its ``default_config()``: Random-X X=10, ND, K=8, patience 2,
   max_colors 1024; P=16) on the traffic mix of its ``_traffic`` (RMAT-ER,
   Good and Bad in turn, edge factor 8, scales 15-17): (a) 12 requests in
   continuous mode (4 lanes, 2 iterations per step) on a ``FakeClock``,
   one arrival per tick — every result valid and bitwise its solo
   ``pipeline_sim`` of its engine-padded member on the card with the
   request-folded keys, a request admitted beside a running lane, and
   the recolor-mode lane form of ``select_run`` held bitwise against its
   plain version on the engine's largest step run with a frozen or empty
   lane (timed by CUDA events, L2 flushed); (b) ``SERVE_OPEN_LOOP``
   requests on a hybrid clock (scripted Poisson arrivals, each poll costing its measured wall
   seconds) in continuous and in flush mode: latency p50/p99, graphs/s,
   polls, engines, routes, launches against the solo runs together, the
   device idle share of the polls, peak device memory; (c) 4 ``grid3d``
   stencils at distance 2 (halo 2, K=4, 2 lanes): valid at distance 2 and
   bitwise their solo runs.  Phase 9's launches print on their own lines;
10. the sharded entry points on a one-rank NCCL world (``launch.mesh``,
   ``init_world`` with a ``file://`` store, no network), one shard of P=1
   per rank: (a) ``pipeline_sharded`` on ``MeshSpec.worker(1)`` on phase
   3's graph at full width (2^20 vertices, MAXD 678, the quality preset,
   K=8), against a counted ``pipeline_sim`` of the same partition on the
   card: view, color stats and history bitwise, valid at distance 1, the
   same launches of every kernel; the NCCL collectives of a profiled
   repeat by name and count; (b) ``color_many_sharded`` on
   ``MeshSpec.coloring(1, batch=1)`` on phase 8's 8 x ``rmat_good(17, 8)``
   at P=1: every lane bitwise ``color_many``'s, the same launches; (c)
   ``ColoringService(mesh=MeshSpec.coloring(1, 1))`` on phase 9(a)'s
   script at P=1: every result bitwise the ``mesh=None`` service's;
11. the coloring system's last modules, on the same one-rank world: (a)
   the three examples (``examples/torch_quickstart.py``,
   ``torch_coloring_sched.py``, ``torch_distributed_coloring.py``, the
   last one's sharded leg on the world) at their own sizes, every
   coloring valid; (b) ``roofline.coloring_memory_projection`` with phase
   3's and phase 5's partition fractions beside the bytes of the tensors
   ``to_device`` makes of those partitions (each array the projection
   names equal, byte for byte) and the path's measured peak; (c) the
   collective audit's recorder around 10(a)'s ``pipeline_sharded``: its
   calls by op, which must be 51 ``all_reduce`` and 1 ``all_gather``, the
   count 10(a)'s profiler read (PERF.md §5); (d) the ``--coloring`` dry-run
   record of ``rmat_er(18, 8, seed=1)`` at P=256, printed;
12. the LM serving path (``repro_torch.launch.serve``, plain PyTorch: no
   TPU kernel lies on it, so it adds nothing to the ``kernels`` line):
   (a) ``qwen3-0.6b`` and (b) ``minicpm3-4b`` at their published widths and
   depths in bf16, random weights from a seeded generator on the card,
   served twice (cold, warm) with batch 8, prompt 512, gen 64: prefill and
   decode seconds, tokens/s, the decode step beside its weight-bytes bound,
   the device time of a prefill and of decode steps (torch.profiler), the
   peak memory, and the decode equivalence (prefill over S tokens plus one
   decode step against the full forward over S+1, within ``LM_BF16_TOL``
   of the largest logit, logits finite); (c) every architecture at smoke
   size in float32 (TF32 off), the same weights and prompts served on the
   card and on the CPU: logits within ``LM_F32_TOL``, greedy tokens equal
   up to each row's first near-tie;
13. the LM training path (``repro_torch.launch.train``, plain PyTorch: no
   TPU kernel lies on it either): (a) ``qwen3-0.6b`` at its published
   width and depth (bf16 parameters and compute, per-layer remat,
   float32 AdamW state) through ``launch/train.py``'s ``Trainer``: batch
   8 x seq 1024, 16 steps, a checkpoint every 8 into a temporary
   directory, an injected failure at step 12 (one restart, the replayed
   steps 9-12 within ``TRAIN_REPLAY_TOL`` of the first pass, every loss
   finite, the last below the first); cold and warm step seconds,
   tokens/s, the model-flops share of the dense bf16 peak, the device
   time and idle share of a profiled warm step with its top consumers,
   the peak memory, each checkpoint's and the restore's seconds and
   bytes; (b) one step at ``grad_accum=2`` against ``grad_accum=1`` on
   (a)'s first batch and initial state, within ``TRAIN_ACCUM_TOL``; (c)
   every architecture at smoke size in float32 (TF32 off): ``loss_fn``,
   its gradients and one AdamW step on the card against the CPU, within
   ``TRAIN_F32_TOL`` (the CPU tests' tolerances);
14. the LM on a mesh of ranks (``repro_torch.parallel.shard``, plain
   PyTorch on ``torch.distributed``: GSPMD placed the reference's shards,
   no TPU kernel): (a) a one-rank NCCL world, ``MeshSpec.local().build()``:
   ``qwen3-0.6b`` at phase 13's shape, ``MESH_TRAIN_STEPS`` steps of the
   sharded ``make_train_step`` (per-layer gathers, gradient reductions and
   the sharded global norm over the one rank) bitwise the unsharded step on
   the same weights and batches, then a sharded checkpoint saved and
   restored bitwise; (b) ``launch.dryrun.dryrun_cell`` on ``pod16x16`` for
   ``qwen3-0.6b`` x the four shapes and ``minicpm3-4b`` x ``decode_32k``
   (``meta`` tensors only, in ``DRY_WORKERS`` background processes
   started before phase 12, each cell limited to ``DRY_LIMIT_S``), with
   each cell's seconds, every cell ``ok`` or ``skipped`` (a cell past its
   limit fails the phase); (c) the dry run at mesh (1, 1) on phase 13's and
   phase 12's own shapes, its predicted peak beside the peak those phases
   measured (``torch.cuda.max_memory_allocated``), within
   ``DRY_PEAK_RATIO``.  No dry-run process initialises CUDA.  The cells
   run with the compute split along ``model`` (the query heads, MLP
   columns, experts and vocabulary where the plan splits them); each line
   prints the storage-only split's readings beside its own, and
   ``qwen3-0.6b`` ``train_4k`` must stay within ``TP_DRY_LIMITS``; the same
   cell again with the sequence-parallel residual (``seq_parallel_acts``:
   a peak at least ``SP_DRY_LIMITS`` GiB lower, no all-reduce of a (B, S,
   d) activation, FLOPs within 1%) and at ``grad_accum=4`` (the
   non-expert weights gathered once a step: all-gather bytes no more than
   at 1), each beside the cell (``DRY_VARIANTS``), with wire bytes;
15. the compute split on a ``(1, 2)`` gloo world of two host processes
   (one card cannot hold two NCCL ranks): ``qwen3-0.6b`` at its published
   widths (d 1024, 16 query / 8 KV heads of 128, vocabulary 151936) cut
   to ``TP_LAYERS`` layers, float32, seeded weights
   (``launch.serve.init_params_placed``): one ``make_train_step`` on a
   batch of ``TP_BATCH`` x ``TP_SEQ`` and ``launch.serve.serve``'s
   prefill plus ``TP_GEN`` greedy tokens, each held to the same run in
   one process within the CPU tests' tolerances (``TP_TOL``: the loss, the
   gradient norm, every leaf's gradient, the prefill's logits; tokens
   equal up to each row's first near-tie); then, on the same world, the
   train step with the sequence-parallel residual against the same
   one-process step within ``TP_TOL``.  It replaces no phase on the
   card;
16. the sub-quadratic models on a mesh (``models.ssm``'s split of RWKV-6's
   heads, its channel mix and Mamba's ``di`` along ``model``; caches
   stored by the plan's spec of every dim; decode over a cache whose
   slots are split over ``data``; plain PyTorch, no TPU kernel): (a)
   ``rwkv6-1.6b`` at its published width and depth (24 layers, d 2048,
   d_ff 7168, vocabulary 65536) in bf16 on the card: served as phase 12
   serves (batch 8, prompt 512, gen 64, the decode equivalence within
   ``LM_BF16_TOL``), then a cold step and four warm ones (the last
   profiled) of ``make_train_step`` at 8 x 1024 (remat, float32 AdamW):
   step seconds,
   tokens/s, the model-flops share, device idle and top consumers of a
   profiled warm step, peak memory; (b) the SSM split on a ``(1, 2)``
   gloo world of two host processes against one process, as phase 15:
   ``rwkv6-1.6b``'s published widths cut to 1 layer and
   ``jamba-v0.1-52b``'s cut to its first layer (Mamba with d 4096, di
   8192, d_state 16, dt_rank 256, and its dense SwiGLU), float32, seeded
   weights, one microbatch, batch 2 x ``SPLIT_SEQ``; the loss, the gradient norm, every leaf's
   gradient (AdamW's m) and the prefill's logits within the CPU tests'
   tolerances (``SSM_SPLIT_TOL``), tokens equal up to each row's first
   near-tie, after a check of the host's free memory; (c) batch-1
   serving of ``qwen3-0.6b``'s published widths cut to 2 layers, float32,
   a ``SEQ_PROMPT``-token prompt in a ``SEQ_CACHE``-slot cache and
   ``SEQ_GEN`` greedy tokens, on a ``(2, 1)`` gloo world (the cache's
   slots split over ``data``) against one process fed the same tokens:
   the gathered cache bitwise after the prefill and in the first layer
   after the decode, the rest and the logits within ``SEQ_TOL``, the
   tokens equal; (d) the dry cells ``SSM_DRY_CELLS`` (``rwkv6-1.6b`` x the
   four shapes, ``jamba-v0.1-52b`` x ``decode_32k`` and ``long_500k`` on
   ``pod16x16``; started before phase 12, beside phases 12-16(a)) beside PR
   24's readings (``SSM_DRY_PR24``), within ``SSM_DRY_LIMITS``, every
   decode cell's ``cache_seq_replicated`` false, and ``rwkv6-1.6b``
   ``train_4k`` with the sequence-parallel residual beside its cell
   (``SSM_DRY_VARIANTS``: a peak at least ``SP_DRY_LIMITS`` GiB lower);
17. Mamba's selective scan (``models.ssm.mamba_scan``: a log-depth scan
   in chunks that ``SCAN_CHUNK_BYTES`` sizes, with its own backward; plain
   PyTorch, no TPU kernel) and ``jamba-v0.1-52b`` at its published widths
   (d 4096, di 8192, d_state 16, dt_rank 256, 32 query / 8 KV heads, 16
   experts top-2 of d_ff 14336, vocabulary 65536) in bf16 on the card:
   (a) cut to its first ``SCAN_SERVE_LAYERS`` layers (one period of the
   interleave: the whole model's 96 GiB of weights do not fit), served as
   phase 12 serves, its peak beside phase 12's; the decode equivalence
   within ``LM_BF16_TOL`` with ample MoE capacity and the routers' picks
   pinned to the full forward's, the picks that the two paths made on
   their own and that differ reported with their margins; (b) one Mamba layer at full width, float32,
   ``SCAN_BATCH`` x ``SCAN_SEQ``: the scan against its plain version
   ``_mamba_scan_steps`` on the layer's own inputs (y, the last state and
   every input's gradient within ``SCAN_TOL``), the walls and peaks of
   each; (c) cut to ``SCAN_TRAIN_LAYERS`` layers (Mamba + SwiGLU, Mamba +
   MoE) through ``make_train_step`` at 8 x 1024 with its own grad_accum 8
   and bf16 AdamW state, remat: a cold step, warm ones and a profiled
   one, every loss finite; (d) ``SCAN_DRY_CELLS`` (``train_4k`` and
   ``prefill_32k`` on ``pod16x16``) among 16(d)'s cells, each ``ok`` and
   fitting the card.  They run in the order 16(a), 17(a-c), 14(b, c),
   16(d) and 17(d), 15, 16(b), 16(c).

Then the ``kernels`` JSON line, the ``nvidia-smi`` line and, last, the
result line.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import itertools
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory (NVIDIA data sheet)
CUDA_CORE_OPS_PER_S = 67e12  # H100 SXM non-tensor peak (fp32; no int32 figure)
DEVICE = "cuda:0"
MAIN_SCALE, MAIN_P, MAIN_K = 20, 64, 8
CROSS_SCALE, CROSS_P, CROSS_K = 18, 16, 4
MAXD, MAX_COLORS = 678, 1024
TILE_ROWS = {"speculative tile": 64 * 128, "recolor chunk": 64 * 256}
CONFLICT_ROWS = 64 * 512
# the distance-2 path: grid3d's 27-point stencil on the two-hop halo
D2_GRID, D2_P, D2_K, D2_TILE = (64, 64, 64), 16, 8, 16
D2_CROSS_GRID, D2_CROSS_K = (32, 32, 32), 4
D2_MAXD, D2_MAXD2 = 26, 98
D2_TILE_ROWS = {"speculative tile": D2_P * D2_TILE,
                "recolor chunk": D2_P * 256}
D2_CONFLICT_ROWS = D2_P * 512
SELECTIONS = (("first_fit", 0), ("staggered", 0), ("random_x", 10))
WARM_RUNS = 5  # warm repeats of each full-size path, for their median walls
# the sequential kernels' timing: readings of launches each, and the
# buffer written to flush the L2 cache (50 MB on an H100) before a launch
GREEDY_READINGS, GREEDY_LAUNCHES = 5, 20
FLUSH_BYTES = 128 << 20
HOST_COVER_CYCLES = 1_000_000  # about 0.5 ms of device wait per launch
# the batched path (phase 8): two D1 buckets of scale-17 RMAT graphs, one
# D2 bucket of two 27-point stencils
MANY_SCALE, MANY_P, MANY_K = 17, 16, 8
MANY_GOOD, MANY_BAD = range(1, 9), range(1, 5)
D2_MANY_GRID = (32, 32, 24)
# the service (phase 9): the default config on P=16, engines of 4 lanes
# stepping 2 iterations; the traffic mix at scales 15-17
SERVE_P, SERVE_LANES, SERVE_CHUNK = 16, 4, 2
SERVE_SCALES, SERVE_SEED = (15, 17), 0
# 9(b) takes the first 12 of the 24 graphs of traffic (24 before phase 17
# came: its seconds go with the requests, each partitioned on the host);
# 10(c) takes all 24
SERVE_BITWISE, SERVE_OPEN_LOOP, SERVE_TRAFFIC = 12, 12, 24
SERVE_D2_GRIDS = ((32, 32, 32), (32, 32, 24), (24, 24, 24), (32, 24, 24))
SERVE_D2_K, SERVE_D2_LANES = 4, 2
SERVE_KERNELS = ("select_run", "conflict_frontier")
# the sharded entry points (phase 10): one rank, so one shard
MESH_P = 1
# phase 11: the collectives of 10(a)'s pipeline_sharded (PERF.md §5, the
# profiler's count in PR 19) and the dry run's production cell
MESH_COLLECTIVES = {"all_reduce": 51, "all_gather": 1}
DRYRUN_SCALE, DRYRUN_P = 18, 256
SERVE_D2_KERNELS = ("select_run_d2", "conflict_frontier_d2")
# phase 12: the LM serving path, two architectures at their published widths
# and depths in bf16, then every architecture at smoke size in float32 on
# the card against the CPU.  Tolerances are relative to the largest logit.
LM_FULL = ("qwen3-0.6b", "minicpm3-4b")
LM_BATCH, LM_PROMPT, LM_GEN, LM_SEED = 8, 512, 64, 0
# prefill + decode against the full forward in bf16: 2x the larger of the
# two errors measured on an NVIDIA H100 80GB HBM3 at 700 W (2.5e-2,
# minicpm3-4b's 62 layers; qwen3-0.6b 1.0e-2)
LM_BF16_TOL = 0.05
LM_SMOKE = dict(batch=4, prompt_len=64, gen=24)
# the card against the CPU in float32, TF32 off: the CPU tests' tolerance
# (at most 3.4e-6 on an NVIDIA H100 80GB HBM3 at 700 W, jamba's mamba scan)
LM_F32_TOL = 1e-5
LM_PROFILED_STEPS = 4
# phase 13: the LM training path, qwen3-0.6b at its published width and
# depth (bf16, remat, float32 AdamW state) through launch/train.py's
# Trainer, then every architecture at smoke size in float32 card against
# CPU at the CPU tests' tolerances (tests/test_torch_train_parts.py)
TRAIN_ARCH = "qwen3-0.6b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 1024, 16
TRAIN_CKPT_EVERY, TRAIN_FAIL_AT = 8, 12
H100_BF16_PEAK = 989.4e12   # H100 SXM dense bf16 (NVIDIA data sheet)
TRAIN_TOP = 8
# the replayed steps 9-12 against the first pass: twice the largest gap
# measured on an NVIDIA H100 80GB HBM3 at 700 W, which was 0 (the step's
# kernels are deterministic: the embedding's backward sorts its indices,
# the cross entropy's gather scatters to distinct positions)
TRAIN_REPLAY_TOL = 0.0
# 13(b), grad_accum 2 against 1 (bf16 gradients of two microbatches summed
# in float32 against one bf16 gradient): the loss (measured 0), m and v
# within 3e-2 of each leaf's largest (2x the 1.49e-2 measured), each
# parameter within one bf16 rounding of its value plus twice the step's
# largest move (measured at most 0.824 of that bound)
TRAIN_ACCUM_TOL = dict(loss=1e-5, state=3e-2, params=1.0)
TRAIN_SMOKE_BATCH, TRAIN_SMOKE_SEQ = 2, 64
TRAIN_F32_TOL = dict(loss=1e-5, grad=1e-4, step=1e-5)


def phase(name: str, t0: float, detail: str = "") -> None:
    print(f"[phase] {name}: {time.perf_counter() - t0:.3f} s {detail}".rstrip(),
          flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def cuda_ms(fn, reps: int) -> float:
    """Mean time per call of ``fn()`` between CUDA events around ``reps``
    calls.  When the calls are host-bound (a small tile behind a Python
    wrapper) this is the host's enqueue time, not the kernel's."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int, kernel: str | None = None,
              skip: str | None = None, warm: bool = True,
              per_call: int | None = 1) -> float:
    """Mean device time per call of ``fn()`` over ``reps`` calls, from
    torch.profiler's trace of the device: the events of the kernel named
    ``kernel`` only, or every device event when ``kernel`` is None (but
    those whose name holds ``skip``).  The profiler loses device events
    now and then: a trace with none, or with another count of the named
    kernel's events than ``per_call`` per call (None: not checked), is
    taken again, up to ``TRACE_TRIES`` times in all, and each loss is
    counted in ``LOST_TRACES``.  For a named kernel with ``per_call``
    launches per call the time is the mean of the launches the trace
    holds (the fullest one, when none is whole), times ``per_call``; else
    the sum over ``reps``.  When no trace holds a device event, the calls
    are timed by CUDA events around them (``event_ms``; noted in
    ``LOST_TRACES``).  ``warm=False`` skips the warm-up call (the caller
    has made one)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if warm:
        fn()
    torch.cuda.synchronize()
    counted = kernel is not None and per_call is not None
    best = None  # (total µs, events) of the fullest trace
    for _ in range(TRACE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and (kernel is None or kernel + "_kernel" in e.key)
                  and (skip is None or skip not in e.key)]
        total_us = sum(e.self_device_time_total for e in events)
        n = sum(e.count for e in events)
        if total_us > 0 and (best is None or n > best[1]):
            best = (total_us, n)
        if total_us > 0 and (not counted or n == reps * per_call):
            break
        LOST_TRACES.append(f"{kernel or 'a call'}: {n} events" + (
            f" of {reps * per_call}" if counted else ""))
    if best is None:
        LOST_TRACES.append(f"{kernel or 'a call'}: timed by CUDA events")
        return event_ms(lambda: None, fn, reps)
    total_us, n = best
    if counted:
        return total_us / n * per_call / 1e3
    return total_us / reps / 1e3


LOST_TRACES = []  # traces that lost device events and were taken again
TRACE_TRIES = 5


def time_pair(name: str, kernel_fn, plain_fn, reps: int, plain_reps: int):
    """The kernel's and the plain version's device time per call
    (profiler), and the wrapper's call time (CUDA events), in ms."""
    return dict(ms=device_ms(kernel_fn, reps, name),
                plain_ms=device_ms(plain_fn, plain_reps),
                call_ms=cuda_ms(kernel_fn, reps))


def timing_line(what: str, t: dict, b: float, by: str) -> str:
    return (f"{what}: kernel {t['ms']:.4f} ms device ({t['call_ms']:.4f} ms "
            f"per wrapper call), plain {t['plain_ms']:.4f} ms device, bound "
            f"{b:.4f} ms ({by})")


def live_rows(my_color, active, tiles) -> tuple[int, int]:
    """Rows that can lose (active and colored), and the entries of those
    rows whose neighbour color equals the row's: only there is a
    neighbour's priority needed."""
    live = (active != 0) & (my_color > 0)
    n_match = sum(int(((t == my_color[:, None]) & live[:, None]).sum())
                  for t in tiles)
    return int(live.sum()), n_match


def conflict_bytes(n_live: int, n_match: int, width: int, rows: int) -> int:
    """Bytes a conflict test must move: the neighbour colors and the own
    priority of the live rows, a neighbour's priority only where the
    colors match, and my_color, active and the output of every row."""
    return n_live * (width * 4 + 4) + n_match * 4 + rows * 12


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / CUDA_CORE_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main_path_tile(gen, rows: int, dev):
    """A (rows, MAXD) neighbour-color tile shaped like the main path's:
    heavy-tailed degrees, sentinel (color 0) padding, a few out-of-range
    entries, ~90% active rows."""
    deg = np.minimum(gen.zipf(1.6, rows) * 4, MAXD)
    cols = np.arange(MAXD)[None, :]
    colors = gen.integers(1, 80, (rows, MAXD))
    colors[gen.random((rows, MAXD)) < 0.01] = MAX_COLORS + 5
    tile = np.where(cols < deg[:, None], colors, 0).astype(np.int32)
    active = gen.random(rows) < 0.9
    rand = gen.integers(-2**31, 2**31, rows, dtype=np.int64).astype(np.int32)
    offset = gen.integers(0, MAX_COLORS, rows).astype(np.int32)
    to = lambda a: torch.from_numpy(a).to(dev)
    return to(tile), to(active), to(rand), to(offset)


def phase_kernels(ops, dev) -> dict:
    """Phase 2, distance 1: both kernels against their plain versions;
    returns the kernels line's measured fields."""
    gen = np.random.default_rng(0)

    def select(tile, act, rand, off, sel, x, backend, mc=MAX_COLORS):
        return ops.select_colors(tile, act, rand, max_colors=mc,
                                 selection=sel, x=x, offset=off,
                                 backend=backend)

    # random tiles with out-of-range colors, and a batched (B, V, D) tile
    for shape in ((300, 21), (3, 257, 13)):
        tile = torch.from_numpy(
            gen.integers(-2, 128 + 8, shape).astype(np.int32)).to(dev)
        act = torch.from_numpy(gen.random(shape[:-1]) < 0.85).to(dev)
        rand = torch.from_numpy(gen.integers(-2**31, 2**31, shape[:-1])
                                .astype(np.int32)).to(dev)
        off = torch.from_numpy(gen.integers(0, 128, shape[:-1])
                               .astype(np.int32)).to(dev)
        for sel, x in SELECTIONS + ((ops.RANDOM_X, 7),):
            got = select(tile, act, rand, off, sel, x, "cuda", 128)
            want = select(tile, act, rand, off, sel, x, "torch", 128)
            check(torch.equal(got, want), f"select {sel} x={x} on {shape}")
        prio = torch.from_numpy(gen.integers(0, 10_000, shape)
                                .astype(np.int32)).to(dev)
        myc = tile[..., 0].clamp(min=0)
        myp = prio[..., 0]
        got = ops.detect_conflicts(myc, myp, tile, prio, act, backend="cuda")
        want = ops.detect_conflicts(myc, myp, tile, prio, act, backend="torch")
        check(torch.equal(got, want), f"conflict on {shape}")

    # the saturation rows: only the reserved sentinel free / one legal color
    mc = 64
    full = np.arange(1, mc - 1, dtype=np.int32)
    rows = torch.from_numpy(np.stack([
        full, np.where(full == 5, 0, full), np.where(full == mc - 2, 0, full),
    ])).to(dev)
    ones = torch.ones(3, dtype=torch.bool, device=dev)
    forty = torch.full((3,), 40, dtype=torch.int32, device=dev)
    for sel, x in SELECTIONS:
        got = select(rows, ones, None, forty, sel, x, "cuda", mc)
        check(got.tolist() == [mc - 1, 5, mc - 2],
              f"saturation rows {sel}: {got.tolist()}")

    out = {}
    lines = []
    for where, n_rows in TILE_ROWS.items():
        tile, act, rand, off = main_path_tile(gen, n_rows, dev)
        n_act = int(act.sum())
        for sel, x in SELECTIONS:
            got = select(tile, act, rand, off, sel, x, "cuda")
            want = select(tile, act, rand, off, sel, x, "torch")
            err = int((got - want).abs().max())
            check(err == 0, f"select {sel} at {where} shape ({n_rows}, {MAXD})")
            tm = time_pair(
                "color_select",
                lambda: select(tile, act, rand, off, sel, x, "cuda"),
                lambda: select(tile, act, rand, off, sel, x, "torch"), 50, 3)
            n_bytes = n_act * (MAXD * 4 + 4) + n_rows * 8
            b, by = bound_ms(n_bytes, n_act * MAXD * 4)
            lines.append(timing_line(
                f"color_select {sel:9s} {where} ({n_rows}x{MAXD})", tm, b, by))
            # the kernels line reports the speculative tiles' Random-X call,
            # the main path's color_select (the recolor chunks' First Fit is
            # on the lines above)
            if sel == ops.RANDOM_X and n_rows == TILE_ROWS["speculative tile"]:
                out["color_select"] = dict(tm, bound=b, by=by, err=err)

    tile, act, _, _ = main_path_tile(gen, CONFLICT_ROWS, dev)
    prio = torch.from_numpy(gen.integers(0, 2**20, tile.shape)
                            .astype(np.int32)).to(dev)
    myc = torch.from_numpy(gen.integers(0, 80, CONFLICT_ROWS)
                           .astype(np.int32)).to(dev)
    myp = torch.from_numpy(gen.integers(0, 2**20, CONFLICT_ROWS)
                           .astype(np.int32)).to(dev)
    conf = lambda backend: ops.detect_conflicts(myc, myp, tile, prio, act,
                                                backend=backend)
    got, want = conf("cuda"), conf("torch")
    err = int((got.int() - want.int()).abs().max())
    check(err == 0, f"conflict at ({CONFLICT_ROWS}, {MAXD})")
    n_live, n_match = live_rows(myc, act, (tile,))
    tm = time_pair("conflict", lambda: conf("cuda"), lambda: conf("torch"),
                   50, 3)
    b, by = bound_ms(conflict_bytes(n_live, n_match, MAXD, CONFLICT_ROWS),
                     n_live * MAXD * 2 + n_match)
    lines.append(timing_line(
        f"conflict  conflict chunk ({CONFLICT_ROWS}x{MAXD})", tm, b, by)
        + f", {int(got.sum())} losers")
    out["conflict"] = dict(tm, bound=b, by=by, err=err)
    for line in lines:
        print("  " + line)
    return out


def d2_tiles(gen, rows: int, dev, lead=()):
    """One-hop (rows, 26) and two-hop (rows, 98) tiles shaped like the
    27-point stencil's: full rows inside the grid, shorter ones on its
    faces, colors in the D2 coloring's range with a few out of range,
    ~90% active rows.  Returns the tiles and the per-row operands."""
    shape = lead + (rows,)

    def tile(width):
        full = gen.random(shape) < 0.9
        deg = np.where(full, width, gen.integers(width // 3, width, shape))
        colors = gen.integers(1, 160, shape + (width,))
        colors[gen.random(shape + (width,)) < 0.01] = MAX_COLORS + 5
        cols = np.arange(width)
        return np.where(cols < deg[..., None], colors, 0).astype(np.int32)

    to = lambda a: torch.from_numpy(a).to(dev)
    return dict(
        nbr=to(tile(D2_MAXD)), nbr2=to(tile(D2_MAXD2)),
        active=to(gen.random(shape) < 0.9),
        rand=to(gen.integers(-2**31, 2**31, shape, dtype=np.int64)
                .astype(np.int32)),
        offset=to(gen.integers(0, MAX_COLORS, shape).astype(np.int32)),
        prio=to(gen.integers(0, 2**18, shape + (D2_MAXD,)).astype(np.int32)),
        prio2=to(gen.integers(0, 2**18, shape + (D2_MAXD2,)).astype(np.int32)),
        my_color=to(gen.integers(0, 160, shape).astype(np.int32)),
        my_prio=to(gen.integers(0, 2**18, shape).astype(np.int32)))


def phase_kernels_d2(ops, dev) -> dict:
    """Phase 2, distance 2: both D2 kernels against their plain versions;
    returns the kernels line's measured fields."""
    gen = np.random.default_rng(1)

    def select(t, sel, x, backend, mc=MAX_COLORS):
        return ops.select_colors_d2(t["nbr"], t["nbr2"], t["active"],
                                    t["rand"], max_colors=mc, selection=sel,
                                    x=x, offset=t["offset"], backend=backend)

    def conflicts(t, backend):
        return ops.detect_conflicts_d2(
            t["my_color"], t["my_prio"], t["nbr"], t["prio"], t["nbr2"],
            t["prio2"], t["active"], backend=backend)

    # random tiles with out-of-range colors, and a batched (B, V, D) tile
    for rows, lead in ((300, ()), (257, (3,))):
        t = d2_tiles(gen, rows, dev, lead)
        t["nbr"] = torch.from_numpy(gen.integers(
            -2, 128 + 8, tuple(t["nbr"].shape)).astype(np.int32)).to(dev)
        t["nbr2"] = torch.from_numpy(gen.integers(
            -2, 128 + 8, tuple(t["nbr2"].shape)).astype(np.int32)).to(dev)
        t["my_color"] = t["my_color"] % 128
        for sel, x in SELECTIONS + (("random_x", 7),):
            check(torch.equal(select(t, sel, x, "cuda", 128),
                              select(t, sel, x, "torch", 128)),
                  f"select_d2 {sel} x={x} on {lead + (rows,)}")
        check(torch.equal(conflicts(t, "cuda"), conflicts(t, "torch")),
              f"conflict_d2 on {lead + (rows,)}")

    # the saturation rows, their taken colors split between the tiles
    mc = 64
    full = np.arange(1, mc - 1, dtype=np.int32)
    rows = np.stack([full, np.where(full == 5, 0, full),
                     np.where(full == mc - 2, 0, full)])
    half = rows.shape[1] // 2
    sat = dict(nbr=torch.from_numpy(rows[:, :half].copy()).to(dev),
               nbr2=torch.from_numpy(rows[:, half:].copy()).to(dev),
               active=torch.ones(3, dtype=torch.bool, device=dev), rand=None,
               offset=torch.full((3,), 40, dtype=torch.int32, device=dev))
    for sel, x in SELECTIONS:
        got = select(sat, sel, x, "cuda", mc)
        check(got.tolist() == [mc - 1, 5, mc - 2],
              f"d2 saturation rows {sel}: {got.tolist()}")

    out, lines = {}, []
    width = D2_MAXD + D2_MAXD2
    for where, n_rows in D2_TILE_ROWS.items():
        t = d2_tiles(gen, n_rows, dev)
        n_act = int(t["active"].sum())
        for sel, x in SELECTIONS:
            got, want = select(t, sel, x, "cuda"), select(t, sel, x, "torch")
            err = int((got - want).abs().max())
            check(err == 0, f"select_d2 {sel} at {where} ({n_rows} rows)")
            tm = time_pair("color_select_d2",
                           lambda: select(t, sel, x, "cuda"),
                           lambda: select(t, sel, x, "torch"), 200, 10)
            b, by = bound_ms(n_act * (width * 4 + 4) + n_rows * 8,
                             n_act * width * 4)
            lines.append(timing_line(
                f"color_select_d2 {sel:9s} {where} ({n_rows}x{D2_MAXD}+"
                f"{D2_MAXD2})", tm, b, by))
            # as at distance 1, the kernels line reports the speculative
            # tiles' Random-X call (the recolor chunks' are on the lines)
            if sel == "random_x" and where == "speculative tile":
                out["color_select_d2"] = dict(tm, bound=b, by=by, err=err)

    t = d2_tiles(gen, D2_CONFLICT_ROWS, dev)
    got, want = conflicts(t, "cuda"), conflicts(t, "torch")
    err = int((got.int() - want.int()).abs().max())
    check(err == 0, f"conflict_d2 at {D2_CONFLICT_ROWS} rows")
    n_live, n_match = live_rows(t["my_color"], t["active"],
                                (t["nbr"], t["nbr2"]))
    tm = time_pair("conflict_d2", lambda: conflicts(t, "cuda"),
                   lambda: conflicts(t, "torch"), 200, 10)
    b, by = bound_ms(conflict_bytes(n_live, n_match, width, D2_CONFLICT_ROWS),
                     n_live * width * 2 + n_match)
    lines.append(timing_line(
        f"conflict_d2 conflict chunk ({D2_CONFLICT_ROWS}x{D2_MAXD}+"
        f"{D2_MAXD2})", tm, b, by) + f", {int(got.sum())} losers")
    out["conflict_d2"] = dict(tm, bound=b, by=by, err=err)
    for line in lines:
        print("  " + line)
    return out


def run_bound(before, after, nbrs, visited: int, sentinel: int,
              speculative: bool, random_x: bool,
              extra_bytes: int = 0) -> tuple[float, str, int]:
    """Bytes bound of one run from its actual active rows (the local rows
    it colored: each went from 0 to a color): 4 B per visited order entry
    (and per visited row's own color, speculative); each active row's ELL
    ids up to its first sentinel (4 B per id, and the 32-B sector that
    holds the terminating sentinel of a row shorter than its width); 4 B
    per gathered neighbour color; 4 B written per active row (and 4 B of
    Random-X draw), plus ``extra_bytes``.  The tile-to-tile dependence is
    not in it."""
    n_local_max = nbrs[0].shape[1]
    act = after[:, :n_local_max] != before[:, :n_local_max]
    n_act = int(act.sum())
    n_ids = n_ends = 0
    for n in nbrs:
        real = n[act] != sentinel
        n_ids += int(real.sum())
        n_ends += int((~real.all(dim=1)).sum())
    n_bytes = (4 * (visited * (2 if speculative else 1) + 2 * n_ids
                    + n_act * (2 if random_x else 1)) + 32 * n_ends
               + extra_bytes)
    b, by = bound_ms(n_bytes, n_ids * 4)
    return b, by, n_act


def unfused_select_run(tile_fn, view, order_pad, nbrs, rand, *, first_step,
                       n_steps, superstep, tile, **select_kw):
    """The speculative loop the run kernel replaced, on the card: per tile
    the ELL gathers, the tile kernel ``tile_fn`` and the scatter (the loop
    of ``ref.select_run`` with the CUDA tile kernel in place of the plain
    selection)."""
    from repro_torch.kernels.ref import take_rows
    n_slots = view.shape[1]
    last = order_pad.shape[1] - tile
    for si in range(first_step, first_step + n_steps):
        for ti in range(-(-superstep // tile)):
            s0 = min(si * superstep + ti * tile, last)
            chunk = order_pad[:, s0:s0 + tile]
            v_safe = chunk.clamp(min=0)
            active = (chunk >= 0) & (take_rows(view, v_safe) == 0)
            tiles = [take_rows(view, take_rows(n, v_safe)) for n in nbrs]
            draws = None if rand is None else take_rows(rand, v_safe)
            colors = tile_fn(*tiles, active, draws,
                             backend="cuda", **select_kw)
            colors = colors.clamp(max=select_kw["max_colors"] - 1)
            idx = torch.where(active, v_safe, n_slots - 1)
            val = torch.where(active, colors, 0)
            view.scatter_(1, idx.long(), val.to(view.dtype))
    return view


def unfused_recolor_run(tile_fn, view, nbrs, sorted_pad, start, sizes,
                        class_chunks, *, first_class, last_class, chunk,
                        max_colors):
    """The recolor loop the run kernel replaced, on the card: per chunk
    the ELL gathers, the First Fit tile kernel and the scatter (the loop of
    ``ref.recolor_run``)."""
    from repro_torch.kernels.ref import take_rows
    n_slots = view.shape[1]
    n_local_max = nbrs[0].shape[1]
    lane = torch.arange(chunk, device=view.device)
    counts = class_chunks[first_class:last_class + 1].tolist()
    for t, n_chunks in enumerate(counts, start=first_class):
        for j in range(n_chunks):
            pos = (start[:, t] + j * chunk).clamp(max=n_local_max)
            active = lane < (sizes[:, t] - j * chunk)[:, None]
            rows = sorted_pad.gather(1, pos[:, None] + lane)
            rows = torch.where(active, rows, 0)
            tiles = [take_rows(view, take_rows(n, rows)) for n in nbrs]
            colors = tile_fn(*tiles, active, max_colors=max_colors,
                             backend="cuda")
            idx = torch.where(active, rows, n_slots - 1)
            val = torch.where(active, colors, 0)
            view.scatter_(1, idx.long(), val.to(view.dtype))
    return view


def unfused_conflict_frontier(ops, view, prio, is_internal, order_pad,
                              nbrs, n_need, *, n_steps, superstep):
    """The repair loop the frontier kernel replaced, on the card: per
    superstep chunk the ELL gathers of colors and priorities, the tile
    kernel ``conflict[_d2]`` and the scatter of the losers (the loop of
    ``ref.detect_conflicts_frontier`` with the CUDA tile kernel)."""
    from repro_torch.kernels.ref import take_rows
    n_slots = view.shape[1]
    new_view = view.clone()
    n_conf = torch.zeros((), dtype=torch.int64, device=view.device)
    bnd = torch.zeros((), dtype=torch.bool, device=view.device)
    offs = torch.arange(superstep, device=view.device)
    test = ops.detect_conflicts if len(nbrs) == 1 else ops.detect_conflicts_d2
    for si in range(n_steps):
        rows = order_pad[:, si * superstep:(si + 1) * superstep]
        active = (rows >= 0) & (si * superstep + offs < n_need[:, None])
        r_safe = rows.clamp(min=0)
        tiles = []
        for n in nbrs:
            nbr_rows = take_rows(n, r_safe)
            tiles += [take_rows(view, nbr_rows), take_rows(prio, nbr_rows)]
        conf = test(take_rows(view, r_safe), take_rows(prio, r_safe), *tiles,
                    active, backend="cuda")
        idx = torch.where(conf, r_safe, n_slots - 1)
        new_view.scatter_(1, idx.long(), 0)
        n_conf = n_conf + conf.sum()
        bnd = bnd | (conf & ~take_rows(is_internal, r_safe)).any()
    return new_view, n_conf, bnd


def frontier_bound(view, prio, order_pad, nbrs, n_need, *, n_steps,
                   superstep) -> tuple[float, str, int, int, int]:
    """Bytes bound of one repair from what this round's view makes it
    read: per active position its order entry and own color (4 B each);
    per live row (active and colored) its ids in ELL order (the nbr row,
    then at distance 2 the nbr2 row), up to its first sentinel or, for a
    loser, up to and including its first winning conflict, each 4 B of id
    and 4 B of gathered color; 4 B of gathered priority per id of those
    that has the row's color, and the row's own priority (4 B) when there
    is such an id; per loser its is_internal flag (1 B) and its write (4
    B).  Counted chunk by chunk on the card; returns the bound, what
    bounds it, and the active, live and losing rows."""
    from repro_torch.kernels.ref import take_rows
    sentinel = view.shape[1] - 1
    offs = torch.arange(superstep, device=view.device)
    zero = torch.zeros((), dtype=torch.int64, device=view.device)
    n_act = n_live = n_lose = n_ids = n_match = n_own = zero
    for si in range(n_steps):
        rows = order_pad[:, si * superstep:(si + 1) * superstep]
        r_safe = rows.clamp(min=0)
        act = (rows >= 0) & (si * superstep + offs < n_need[:, None])
        myc, myp = take_rows(view, r_safe), take_rows(prio, r_safe)
        live = act & (myc > 0)
        ids = torch.cat([take_rows(n, r_safe) for n in nbrs], dim=2)
        real = (ids != sentinel) & live[..., None]
        match = real & (take_rows(view, ids) == myc[..., None])
        win = match & (take_rows(prio, ids) > myp[..., None])
        # an id is read iff no winning conflict comes before it in the row
        read = real & (win.cumsum(dim=2) - win.long() == 0)
        n_act = n_act + act.sum()
        n_live = n_live + live.sum()
        n_lose = n_lose + win.any(dim=2).sum()
        n_ids = n_ids + read.sum()
        n_match = n_match + (match & read).sum()
        n_own = n_own + (match & read).any(dim=2).sum()
    n_act, n_live, n_lose, n_ids, n_match, n_own = (
        int(x) for x in (n_act, n_live, n_lose, n_ids, n_match, n_own))
    n_bytes = 8 * (n_act + n_ids) + 4 * (n_match + n_own) + 5 * n_lose
    b, by = bound_ms(n_bytes, n_ids * 2)
    return b, by, n_act, n_live, n_lose


class _FirstRepair(Exception):
    """Ends a run at its first repair (``capture_first_repair``)."""


def capture_first_repair(run) -> dict:
    """The arguments of a path's first repair: round 0's pre-repair view,
    as the round's supersteps and boundary exchanges left it, and the
    round's visit order, frontier, device arrays and lane count.  The path
    (``run()``) is run once more (its launches are not counted) with
    ``speculative._detect_conflicts_frontier`` replaced by a stand-in that
    records its arguments and ends the run."""
    from repro_torch.core import speculative
    seen = {}

    def first_repair(view, arrs, order_pad, n_steps, n_need, superstep,
                     lanes=1, **_):
        seen.update(view=view, arrs=arrs, order_pad=order_pad,
                    n_steps=n_steps, n_need=n_need, superstep=superstep,
                    lanes=lanes)
        raise _FirstRepair

    real = speculative._detect_conflicts_frontier
    speculative._detect_conflicts_frontier = first_repair
    try:
        run()
    except _FirstRepair:
        pass
    finally:
        speculative._detect_conflicts_frontier = real
    check(bool(seen), "the path made no repair")
    return seen


def phase_frontier(ops, seen: dict, d2: bool) -> dict:
    """The frontier kernel of this path against its plain version on the
    path's own round-0 repair (``capture_first_repair``).  Bitwise (view,
    counts and boundary flags, per lane on a batch of lanes), and the
    unfused sequence too (its totals); returns the kernel's time per
    launch by CUDA events with the L2 flushed (the kernel alone:
    ``ops.launch_frontier`` into a prepared copy of the view), its
    profiler reading, the entry point's (its view copy and count buffer
    included), the plain version's and the unfused sequence's device time
    (gathers + tile kernel + scatter per superstep chunk), and the
    bound."""
    name = "conflict_frontier_d2" if d2 else "conflict_frontier"
    arrs, view, order_pad, n_need = (seen[k] for k in (
        "arrs", "view", "order_pad", "n_need"))
    L = seen.get("lanes", 1)
    nbrs = (arrs["nbr"], arrs["nbr2"]) if d2 else (arrs["nbr"],)
    P = view.shape[0]
    fn = ops.detect_conflicts_frontier_d2 if d2 else (
        ops.detect_conflicts_frontier)
    args = (view, arrs["prio"], arrs["is_internal"], order_pad, *nbrs, n_need)
    kw = dict(n_steps=seen["n_steps"], superstep=seen["superstep"])
    run = lambda backend: fn(*args, backend=backend, lanes=L, **kw)
    unfused = lambda: unfused_conflict_frontier(
        ops, view, arrs["prio"], arrs["is_internal"], order_pad, nbrs, n_need,
        **kw)
    got, want, old = run("cuda"), run("torch"), unfused()
    err = int((got[0] - want[0]).abs().max())
    n_losers = int(want[1].sum())
    check(err == 0 and torch.equal(got[1], want[1])
          and torch.equal(got[2], want[2]),
          f"{name}: kernel and plain repairs differ")
    check(torch.equal(old[0], want[0]) and int(old[1]) == n_losers
          and bool(old[2]) == bool(want[2].any()),
          f"{name}: unfused repair differs")
    b, by, n_act, n_live, n_lose = frontier_bound(
        view, arrs["prio"], order_pad, nbrs, n_need, **kw)
    check(n_lose == n_losers, f"{name}: the bound counted {n_lose} losers, "
          f"the repair {n_losers}")
    counts = torch.zeros((L, 2), dtype=torch.int64, device=view.device)
    ms = run_readings(view, lambda new_view: ops.launch_frontier(
        *args[:4], nbrs, n_need, kw["n_steps"] * kw["superstep"], new_view,
        counts), reset=counts.zero_)
    t = dict(ms=statistics.median(ms),
             profiler_ms=device_ms(lambda: run("cuda"), 20, name),
             call_ms=device_ms(lambda: run("cuda"), 20, skip="Memcpy"),
             plain_ms=device_ms(lambda: run("torch"), 3, skip="Memcpy"),
             unfused_ms=device_ms(unfused, 3, skip="Memcpy"),
             bound=b, by=by, err=err)
    lanes = f"{L} lanes of {P // L} shards" if L > 1 else f"{P} shards"
    per_lane = (f", losers per lane {want[1].tolist()}, boundary loser per "
                f"lane {want[2].tolist()}" if L > 1 else "")
    print(f"  {name} round 0 ({lanes} x {kw['n_steps']} superstep chunks "
          f"of {kw['superstep']} rows, the path's own pre-repair view): "
          f"kernel {t['ms']:.4f} ms per launch by CUDA events, L2 flushed "
          f"({spread_note(ms)}; profiler {t['profiler_ms']:.4f} ms; entry "
          f"point {t['call_ms']:.4f} ms device, its view copy included), "
          f"unfused {t['unfused_ms']:.4f} ms device, plain "
          f"{t['plain_ms']:.4f} ms device, bound {b:.4f} ms ({by}), {n_act} "
          f"active rows, {n_live} live, {n_losers} losers "
          f"({n_losers / max(n_live, 1):.4f} of the live rows), boundary "
          f"loser {bool(want[2].any())}{per_lane}")
    return {name: t}


def phase_runs(core, ops, dev, pg, order, cfg, view_final) -> dict:
    """The run kernel of this path against its plain version on the
    path's own arrays: a speculative run (the middle superstep of round 0,
    the earlier ones colored first by the kernel) and a recolor run (the
    largest class of an ND iteration seeded with ``view_final``, the
    earlier classes colored first).  Bitwise; prints the kernel's device
    time per launch, the plain version's and the unfused sequence's
    (gathers + tile kernel + scatters), and the bound.  Returns the
    speculative run's numbers for the kernels line."""
    from repro_torch import rng
    from repro_torch.core import recolor as rc
    cfg = core.resolve_pipeline_cfg(pg, cfg)
    ccfg, rcfg = cfg.color, cfg.recolor
    d2 = ccfg.distance == 2
    name = "select_run_d2" if d2 else "select_run"
    arrs = core.to_device(pg, dev, sparse=False)
    nbrs = (arrs["nbr"], arrs["nbr2"]) if d2 else (arrs["nbr"],)
    P, n_slots = arrs["prio"].shape
    n_local_max, mc = pg.n_local_max, ccfg.max_colors
    sentinel = n_slots - 1
    tile_fn = ops.select_colors_d2 if d2 else ops.select_colors
    lines = []

    def timed(what, call, base, unfused, before, **bound_kw):
        run = lambda backend: call(base.clone(), backend)
        got, want = run("cuda"), run("torch")
        err = int((got - want).abs().max())
        check(err == 0, f"{name} {what}: kernel and plain views differ")
        check(torch.equal(unfused(), want),
              f"{name} {what}: unfused sequence differs")
        b, by, n_act = run_bound(before, want, nbrs, sentinel=sentinel,
                                 **bound_kw)
        ms = run_readings(base, lambda v: call(v, "cuda"))
        t = dict(ms=statistics.median(ms),
                 profiler_ms=device_ms(lambda: run("cuda"), 20, name),
                 plain_ms=device_ms(lambda: run("torch"), 3, skip="Memcpy"),
                 unfused_ms=device_ms(unfused, 5, skip="Memcpy"),
                 bound=b, by=by, err=err)
        lines.append(
            f"{name} {what}: kernel {t['ms']:.4f} ms per launch by CUDA "
            f"events, L2 flushed ({spread_note(ms)}; profiler "
            f"{t['profiler_ms']:.4f} ms), unfused {t['unfused_ms']:.4f} ms "
            f"device, plain {t['plain_ms']:.4f} ms device, bound {b:.4f} ms "
            f"({by}; the tile-to-tile dependence is not in it), {n_act} "
            "active rows")
        return t

    # speculative: the middle superstep of round 0
    S = min(ccfg.superstep, n_local_max)
    tile = min(ccfg.tile, S)
    order_t = torch.as_tensor(order, device=dev)
    order_pad = torch.cat([order_t, torch.full((P, S), -1, dtype=order_t.dtype,
                                               device=dev)], dim=1)
    key = rng.fold_in(rng.fold_in(rng.key(ccfg.seed), 0),
                      torch.arange(P, device=dev))
    rand = rng.as_int32_bits(rng.bits(key, n_local_max))
    spec = dict(superstep=S, tile=tile, max_colors=mc,
                selection=ccfg.selection, x=ccfg.random_x)
    run_fn = ops.select_run_d2 if d2 else ops.select_run
    mid = -(-n_local_max // S) // 2
    view0 = torch.zeros((P, n_slots), dtype=torch.int32, device=dev)
    run_fn(view0, order_pad, *nbrs, rand, None, first_step=0, n_steps=mid,
           backend="cuda", **spec)

    random_x = ccfg.selection == ops.RANDOM_X
    spec_tile = dict(max_colors=mc, selection=ccfg.selection, x=ccfg.random_x)
    out = timed(
        f"speculative superstep ({P} shards x {-(-S // tile)} "
        f"{ccfg.selection} tiles of {tile} rows)",
        lambda v, backend: run_fn(v, order_pad, *nbrs, rand, None,
                                  first_step=mid, n_steps=1, backend=backend,
                                  **spec), view0,
        lambda: unfused_select_run(tile_fn, view0.clone(), order_pad, nbrs,
                                   rand, first_step=mid, n_steps=1,
                                   superstep=S, tile=tile, **spec_tile),
        view0, visited=P * -(-S // tile) * tile, speculative=True,
        random_x=random_x)

    # recolor: the largest class (the last under ND) of an iteration
    rcfg = dataclasses.replace(rcfg, scheme=core.ALLGATHER)
    sizes, _ = rc.class_sizes(view_final, arrs["n_local"], n_local_max, mc)
    sched = rc.recolor_schedule(arrs, view_final,
                                rc.permutation_rank(sizes, rc.ND),
                                (sizes > 0).sum(), rcfg, 0)
    t_last = sched.n_classes
    chunk = min(rcfg.chunk, n_local_max)
    recolor_fn = ops.recolor_run_d2 if d2 else ops.recolor_run
    sched_args = (sched.sorted_pad, sched.start_local, sched.local_sizes,
                  sched.class_chunks)
    view0 = torch.zeros((P, n_slots), dtype=torch.int32, device=dev)
    recolor_fn(view0, *nbrs, *sched_args, first_class=1,
               last_class=t_last - 1, chunk=chunk, max_colors=mc,
               backend="cuda")

    n_chunks = int(sched.class_chunks[t_last])
    timed(f"recolor class ({P} shards x {n_chunks} first_fit chunks of "
          f"{chunk} rows)",
          lambda v, backend: recolor_fn(v, *nbrs, *sched_args,
                                        first_class=t_last, last_class=t_last,
                                        chunk=chunk, max_colors=mc,
                                        backend=backend), view0,
          lambda: unfused_recolor_run(tile_fn, view0.clone(), nbrs,
                                      *sched_args, first_class=t_last,
                                      last_class=t_last, chunk=chunk,
                                      max_colors=mc),
          view0, visited=P * n_chunks * chunk, speculative=False,
          random_x=False)
    for line in lines:
        print("  " + line)
    return {name: out}


def phase_push(core, ops, dev, pg, cfg, view_final) -> dict:
    """``exchange_push`` against its plain version on this path's own
    exchange and schedule: the fan-out of the path's recoloring exchange
    (its resolved scheme) and the schedule of one ND iteration of
    ``view_final``, every push of the iteration in turn (each run of
    classes between two of its events), from ``view_final`` with its
    ghosts set to 0.  Bitwise after each push, plain, with ``wire16`` and
    with the shards split into two lanes of which the second is frozen;
    after the plain pushes every ghost they write holds ``view_final``'s.
    Times each push by CUDA events, L2 flushed before each launch (the
    mean of ``GREEDY_READINGS`` launches), and the plain pushes' device
    time; the bound: a row id, a color and two offsets a pushed row, a
    4-byte id read and a color written an entry.  Returns the kernels
    line's numbers, the mean of a push."""
    from repro_torch.core import comm
    from repro_torch.core import recolor as rc
    rcfg = core.resolve_pipeline_cfg(pg, cfg).recolor
    arrs = core.to_device(pg, dev, sparse=rcfg.scheme == core.SPARSE)
    fan_ptr, fan_dst, lane_entries = comm.make_exchange(
        arrs, rcfg.comm_config).fan_out()
    n_local_max = pg.n_local_max
    sizes, _ = rc.class_sizes(view_final, arrs["n_local"], n_local_max,
                              rcfg.max_colors, lanes=1)
    sched = rc.recolor_schedule(arrs, view_final,
                                rc.permutation_rank(sizes, rc.ND),
                                (sizes > 0).sum(dim=1), rcfg,
                                comm.sparse_rounds(arrs))
    rows = (sched.sorted_pad, sched.start_local, sched.local_sizes)
    ts = sched.events(0)
    windows = list(zip([1] + [t + 1 for t in ts[:-1]], ts))
    base = view_final.clone()
    base[:, n_local_max:] = 0
    S = base.shape[0]

    def push(view, first, last, backend, lane_on=None, wire16=False):
        return ops.exchange_push(view, fan_ptr, fan_dst, *rows, lane_on,
                                 first_class=first, last_class=last,
                                 wire16=wire16, backend=backend)

    frozen = torch.tensor([1, 0], dtype=torch.int32, device=dev)
    for label, kw in (("", {}), (", wire16", dict(wire16=True)),
                      (", second lane frozen", dict(lane_on=frozen))):
        got, want = base.clone(), base.clone()
        for first, last in windows:
            push(got, first, last, "cuda", **kw)
            push(want, first, last, "torch", **kw)
            check(torch.equal(got, want),
                  f"exchange_push classes {first}..{last}{label}: kernel "
                  "and plain views differ")
        if not kw:
            fan = fan_dst.long()
            check(torch.equal(got.view(-1)[fan], view_final.view(-1)[fan]),
                  "exchange_push: after an iteration's pushes a ghost "
                  "differs from the path's view")
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32, device=dev)
    view = base.clone()
    each = [event_ms(lambda: flush.fill_(next(_FILLS)),
                     lambda f=first, l=last: push(view, f, l, "cuda"),
                     GREEDY_READINGS) for first, last in windows]
    plain = device_ms(lambda: [push(view, f, l, "torch")
                               for f, l in windows], 3, skip="Memcpy")
    n_rows = int(arrs["n_local"].sum())    # each pushed once an iteration
    n_entries = int(lane_entries.sum())
    b, by = bound_ms(n_rows * 16 + n_entries * 8, n_entries)
    n = len(windows)
    print(f"  exchange_push, one ND iteration's {n} pushes ({S} shards, "
          f"{n_rows} rows, fan-out {n_entries} entries, scheme "
          f"{rcfg.scheme}): kernel {sum(each):.4f} ms an iteration by CUDA "
          f"events, L2 flushed (a push: median {statistics.median(each):.4f}"
          f", max {max(each):.4f}), plain {plain:.4f} ms device, bound "
          f"{b:.4f} ms ({by}); bitwise plain, with wire16 and with a "
          "frozen lane", flush=True)
    return dict(ms=sum(each) / n, plain_ms=plain / n, bound=b / n, by=by,
                err=0)


def stage_seconds(res) -> str:
    return ", ".join(f"{k} {v:.3f} s" for k, v in res["seconds"].items())


def drive_path(core, ops, dev, g, pg, order, cfg, kernels) -> dict:
    """One full-size pipeline run with every launch count set to 0 just
    before it and read just after; checks the coloring at the config's
    distance, the iteration count, that each of ``kernels`` launched and
    that the tile-form select and conflict kernels did not.  Then the run
    and frontier kernels against their plain versions on this path
    (``phase_runs``, ``phase_frontier``), the push exchange against its
    plain version on this path's exchange and schedule (``phase_push``)
    and the warm and profiled repeats (``profile_path``).
    Returns the launch counts, ``phase_runs``' numbers (and at distance 1
    ``phase_push``'s) and the view."""
    distance = cfg.color.distance
    torch.cuda.reset_peak_memory_stats(dev)
    for k in ops.KERNELS:
        k.launches = 0
    view, res = core.pipeline_sim(pg, order, cfg, device=dev)
    launches = {k.name: k.launches for k in ops.KERNELS}
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev)
    st = core.check_coloring(g, core.colors_from_views(pg, view),
                             distance=distance)
    c = res["color"]
    print(f"  initial: n_colors_distinct {c['n_colors_distinct']}, "
          f"n_rounds {c['n_rounds']}, n_exchanges {c['n_exchanges']}, "
          f"wire_bytes {c['wire_bytes']}")
    for h in res["history"]:
        print(f"  iteration {h['iteration']}: n_colors_distinct "
              f"{h['n_colors_distinct']}, n_exchanges {h['n_exchanges']}, "
              f"wire_bytes {h['wire_bytes']}")
    d2 = (f", d2 conflicting pairs {st['n_d2_conflicting_pairs']}"
          if distance == 2 else "")
    print(f"  stages: {stage_seconds(res)}; peak device memory "
          f"{peak / 2**30:.3f} GiB; launches {launches}; valid {st['valid']}, "
          f"colors {st['n_colors']}{d2}")
    check(st["valid"], f"distance-{distance} coloring invalid: {st}")
    check(res["n_iters_run"] == cfg.n_iters, "the path ran fewer iterations")
    for name in kernels:
        check(launches[name] > 0, f"kernel {name} never launched on its path")
    for name in ("color_select", "color_select_d2", "conflict",
                 "conflict_d2"):
        check(launches[name] == 0,
              f"the tile kernel {name} launched on the path")
    t = time.perf_counter()
    measured = phase_runs(core, ops, dev, pg, order, cfg, view)
    measured.update(phase_frontier(ops, capture_first_repair(
        lambda: core.pipeline_sim(pg, order, cfg, device=dev)),
        distance == 2))
    phase(f"{'5b' if distance == 2 else '3b'} run and frontier kernels vs "
          "plain (bitwise) on this path's arrays", t)
    t = time.perf_counter()
    push = phase_push(core, ops, dev, pg, cfg, view)
    if distance == 1:
        measured["exchange_push"] = push
    phase(f"{'5c' if distance == 2 else '3c'} exchange_push vs plain "
          "(bitwise) on this path's exchange and schedule", t)
    profile_path(core, pg, order, cfg, dev, res, kernels)
    return launches, measured, view, peak


def phase_main_path(core, ops, dev):
    """Phase 3: the paper's headline experiment at full size.  Returns the
    launch counts, the measured kernels and (graph, partition, order,
    final view) for phase 7."""
    from repro_torch.core import presets
    t = time.perf_counter()
    g = core.rmat.rmat_good(MAIN_SCALE, 8, seed=1)
    t_gen = time.perf_counter() - t
    pg = core.partition_graph(g, MAIN_P)
    order = core.compute_order(pg, core.ordering.INTERNAL_FIRST)
    t_part = time.perf_counter() - t - t_gen
    cfg = presets.pipeline_config(presets.quality(x=10), n_iters=MAIN_K)
    scheme = core.resolve_pipeline_cfg(pg, cfg).recolor.scheme
    print(f"  graph rmat_good({MAIN_SCALE}, 8, seed=1): n={g.n}, m={g.m}, "
          f"P={MAIN_P}, n_local_max={pg.n_local_max}, maxd={pg.maxd}, "
          f"max_ghost={pg.max_ghost}; generate {t_gen:.3f} s, partition+order "
          f"{t_part:.3f} s; scheme {scheme}", flush=True)
    launches, measured, view, peak = drive_path(
        core, ops, dev, g, pg, order, cfg, ("select_run",
                                            "conflict_frontier",
                                            "exchange_push"))
    # the view waits on the host, out of the later paths' peak memory
    return launches, measured, (g, pg, order, view.cpu()), dict(
        label=f"rmat_good({MAIN_SCALE}) P={MAIN_P}", pg=pg, scheme=scheme,
        peak=peak)


def d2_config(presets, n_iters: int):
    """The "quality" preset at distance 2 with the reference's D2 tile."""
    cfg = presets.pipeline_config(presets.quality(x=10), n_iters=n_iters)
    return dataclasses.replace(
        cfg, color=dataclasses.replace(cfg.color, distance=2, tile=D2_TILE),
        recolor=dataclasses.replace(cfg.recolor, distance=2))


def phase_d2_path(core, ops, dev) -> dict:
    """Phase 5: distance-2 coloring of the 27-point stencil at full size.
    Returns the launch counts, the measured kernels and the partition's
    memory record for phase 11."""
    from repro_torch.core import presets
    t = time.perf_counter()
    g = core.rmat.grid3d(*D2_GRID)
    t_gen = time.perf_counter() - t
    pg = core.partition_graph(g, D2_P, halo=2)
    order = core.compute_order(pg, core.ordering.INTERNAL_FIRST)
    t_part = time.perf_counter() - t - t_gen
    cfg = d2_config(presets, D2_K)
    scheme = core.resolve_pipeline_cfg(pg, cfg).recolor.scheme
    n_bytes = sum(a.nbytes for a in pg.arrays(sparse=scheme == core.SPARSE)
                  .values())
    print(f"  graph grid3d{D2_GRID}: n={g.n}, m={g.m}, P={D2_P}, halo=2, "
          f"n_local_max={pg.n_local_max}, maxd={pg.maxd}, maxd2={pg.maxd2}, "
          f"max_ghost={pg.max_ghost}, {n_bytes / 1e6:.1f} MB of partition "
          f"arrays; generate {t_gen:.3f} s, partition+order {t_part:.3f} s; "
          f"scheme {scheme}", flush=True)
    check((pg.maxd, pg.maxd2) == (D2_MAXD, D2_MAXD2),
          f"grid3d ELL widths {(pg.maxd, pg.maxd2)}, want "
          f"{(D2_MAXD, D2_MAXD2)}")
    launches, measured, _, peak = drive_path(
        core, ops, dev, g, pg, order, cfg, ("select_run_d2",
                                            "conflict_frontier_d2",
                                            "exchange_push"))
    return launches, measured, dict(label=f"grid3d{D2_GRID} halo=2 P={D2_P}",
                                    pg=pg, scheme=scheme, peak=peak)


def profile_path(core, pg, order, cfg, dev, res, kernels) -> None:
    """Where the time goes: the path ``WARM_RUNS`` times more unprofiled
    (warm: the counted run was the process's first) and once under
    torch.profiler, their launches not counted.  Prints the warm runs'
    median stage walls.  Device time is summed over the device-side
    events; the idle share compares the device time of the color and
    recolor stages with their wall time in the counted (cold) run and
    with the warm median.  The operators that launched the most device
    time are listed with their input shapes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    warm = [core.pipeline_sim(pg, order, cfg, device=dev)[1]["seconds"]
            for _ in range(WARM_RUNS)]
    median = {k: statistics.median(w[k] for w in warm) for k in warm[0]}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        _, res_p = core.pipeline_sim(pg, order, cfg, device=dev)
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events) / 1e6
    h2d = sum(e.self_device_time_total for e in events
              if "Memcpy" in e.key) / 1e6
    ours = {k: sum(e.self_device_time_total for e in events
                   if k + "_kernel" in e.key) / 1e6
            for k in kernels}
    loop = busy - h2d
    wall = {w: s["color"] + s["recolor"]
            for w, s in (("cold", res["seconds"]), ("warm", median))}
    mine = ", ".join(f"{k} {v:.4f} s" for k, v in ours.items())
    runs = "; ".join(", ".join(f"{k} {v:.4f}" for k, v in w.items())
                     for w in warm)
    print(f"  warm runs (s): {runs}")
    print(f"  warm median of {WARM_RUNS}: "
          + ", ".join(f"{k} {v:.4f} s" for k, v in median.items()))
    print(f"  profiled repeat: {stage_seconds(res_p)}; device busy "
          f"{busy:.4f} s, of it host->device copies {h2d:.4f} s, {mine} "
          f"({sum(ours.values()) / max(loop, 1e-12):.3f} of the loop's "
          f"device time); color+recolor device time {loop:.4f} s over "
          f"{wall['cold']:.4f} s wall unprofiled "
          f"(device idle {1 - loop / wall['cold']:.3f}), over "
          f"{wall['warm']:.4f} s warm median (device idle "
          f"{1 - loop / wall['warm']:.3f})")
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:10]
    for e in top:
        print(f"    {e.self_device_time_total / 1e3:10.3f} ms  {e.count:6d}x  "
              f"{e.key[:90]}")
    by_op = sorted((e for e in prof.key_averages(group_by_input_shape=True)
                    if e.device_type == DeviceType.CPU
                    and e.self_device_time_total > 0),
                   key=lambda e: -e.self_device_time_total)[:12]
    print("  operators by the device time they launched (input shapes; the "
          "copies of the partition arrays are to_device's):")
    for e in by_op:
        print(f"    {e.self_device_time_total / 1e3:10.3f} ms  {e.count:6d}x  "
              f"{e.key[:40]} {str(e.input_shapes)[:110]}")


def cross_runs(core, dev, pg, order, base, schemes, marked=None) -> dict:
    """``pipeline_sim`` of ``base`` with the kernels and with
    ``backend="torch"`` under each of ``schemes``; checks kernels = plain
    (views, color stats, histories) and returns the runs."""
    runs = {}
    for scheme in schemes:
        for backend in ("auto", "torch"):
            cfg = dataclasses.replace(
                base, color=dataclasses.replace(base.color, scheme=scheme,
                                                backend=backend),
                recolor=dataclasses.replace(base.recolor, scheme=scheme,
                                            backend=backend))
            view, res = core.pipeline_sim(pg, order, cfg, marked=marked,
                                          device=dev)
            runs[scheme, backend] = (view, res)
            print(f"  {scheme:9s} {'kernels' if backend == 'auto' else 'plain':7s}"
                  f": {stage_seconds(res)}; colors "
                  f"{res['history'][-1]['n_colors_distinct']}", flush=True)
    for scheme in schemes:
        (v1, r1), (v2, r2) = runs[scheme, "auto"], runs[scheme, "torch"]
        check(torch.equal(v1, v2), f"{scheme}: kernel and plain views differ")
        check(r1["color"] == r2["color"] and r1["history"] == r2["history"],
              f"{scheme}: kernel and plain stats differ")
    return runs


def check_schemes_agree(core, pg, runs) -> None:
    """Sparse = all-gather on local slots and real ghosts, and in every
    stat but the wire bytes."""
    no_bytes = lambda d: {k: v for k, v in d.items() if k != "wire_bytes"}
    (vs, rs), (va, ra) = runs[core.SPARSE, "auto"], runs[core.ALLGATHER, "auto"]
    live = torch.zeros_like(vs, dtype=torch.bool)
    live[:, :pg.n_local_max] = True
    for p in range(pg.P):
        live[p, pg.n_local_max:pg.n_local_max + int(pg.n_ghost[p])] = True
    check(torch.equal(vs[live], va[live]), "sparse and all-gather views differ")
    check(no_bytes(rs["color"]) == no_bytes(ra["color"])
          and [no_bytes(h) for h in rs["history"]]
          == [no_bytes(h) for h in ra["history"]],
          "sparse and all-gather stats differ")


def phase_cross_check(core, dev) -> None:
    """Phase 4: kernels vs plain versions, sparse vs all-gather."""
    from repro_torch.core import presets
    g = core.rmat.rmat_good(CROSS_SCALE, 8, seed=2)
    pg = core.partition_graph(g, CROSS_P)
    order = core.compute_order(pg, core.ordering.INTERNAL_FIRST)
    base = presets.pipeline_config(presets.quality(x=10), n_iters=CROSS_K)
    schemes = (core.SPARSE, core.ALLGATHER)
    runs = cross_runs(core, dev, pg, order, base, schemes)
    st = core.check_coloring(g, core.colors_from_views(pg, runs[core.SPARSE,
                                                                "auto"][0]))
    check(st["valid"], "cross-check coloring invalid")
    check_schemes_agree(core, pg, runs)


def phase_d2_cross_check(core, dev):
    """Phase 6: distance 2 and partial distance 2, kernels vs plain
    versions, sparse vs all-gather.  Returns (graph, partition, order) for
    phase 7."""
    from repro_torch.core import presets
    g = core.rmat.grid3d(*D2_CROSS_GRID)
    pg = core.partition_graph(g, D2_P, halo=2)
    order = core.compute_order(pg, core.ordering.INTERNAL_FIRST)
    base = d2_config(presets, D2_CROSS_K)
    schemes = (core.SPARSE, core.ALLGATHER)
    runs = cross_runs(core, dev, pg, order, base, schemes)
    st = core.check_coloring(g, core.colors_from_views(
        pg, runs[core.SPARSE, "auto"][0]), distance=2)
    check(st["valid"], f"D2 cross-check coloring invalid: {st}")
    check_schemes_agree(core, pg, runs)
    # partial D2 of the even global ids (bipartite column coloring)
    marked_g = np.arange(g.n) % 2 == 0
    marked = np.zeros((pg.P, pg.n_local_max), bool)
    for p in range(pg.P):
        nl, lo = int(pg.n_local[p]), int(pg.offs[p])
        marked[p, :nl] = marked_g[lo:lo + nl]
    base_p = dataclasses.replace(
        base, color=dataclasses.replace(base.color, partial=True))
    runs = cross_runs(core, dev, pg, order, base_p, (core.SPARSE,),
                      marked=marked)
    colors = core.colors_from_views(pg, runs[core.SPARSE, "auto"][0])
    st = core.check_coloring(g, colors, distance=2, marked=marked_g)
    print(f"  partial D2: {int(marked_g.sum())} marked vertices, "
          f"{st['n_colors']} colors, valid {st['valid']}")
    check(st["valid"], f"partial D2 coloring invalid: {st}")
    check(bool((colors[~marked_g] == 0).all()),
          "partial D2 colored an unmarked vertex")
    return g, pg, order


# -- phase 7: the paper's variant paths ---------------------------------------

class _Captured(Exception):
    """Ends a run once its chosen sequential runs are captured."""


def capture_greedy(core, ops, pg, order, cfg, dev) -> dict:
    """Three ``ops.greedy_run[_d2]`` calls of ``color_graph_sim(pg, order,
    cfg)``, by label, each with its arguments and copies of its view and
    usage as they were before it: round 0's first run of supersteps (an
    empty view and usage), its middle one (after exchanges: ghost colors
    in the view, a nonzero usage row) and round 1's first (colored
    vertices among the positions, to be skipped).  A first pass lists each
    call's first superstep (every round's runs start at 0); a second
    captures the three and ends there.  Neither pass's launches count."""
    name = "greedy_run_d2" if cfg.distance == 2 else "greedy_run"
    real = getattr(ops, name)
    steps = []

    def note(*args, **kw):
        steps.append(kw["first_step"])
        return real(*args, **kw)

    setattr(ops, name, note)
    try:
        core.color_graph_sim(pg, order, cfg, device=dev)
    finally:
        setattr(ops, name, real)
    starts = [i for i, s in enumerate(steps) if s == 0]
    check(len(starts) >= 2, f"the path made no second round of {name} "
          f"calls (first supersteps {steps})")
    picks = {0: "round 0 first", starts[1] // 2: "round 0 middle",
             starts[1]: "round 1 first"}
    seen, n_calls = {}, [0]

    def capture(view, usage, order_pad, *args, **kw):
        i, n_calls[0] = n_calls[0], n_calls[0] + 1
        if i in picks:
            seen[picks[i]] = dict(view=view.clone(), usage=usage.clone(),
                                  order_pad=order_pad, args=args, kw=kw)
            if len(seen) == len(picks):
                raise _Captured
        return real(view, usage, order_pad, *args, **kw)

    setattr(ops, name, capture)
    try:
        core.color_graph_sim(pg, order, cfg, device=dev)
    except _Captured:
        pass
    finally:
        setattr(ops, name, real)
    check(len(seen) == len(picks), f"captured {sorted(seen)} of {name}'s "
          f"calls, want {sorted(picks.values())}")
    return seen


def greedy_call(ops, seen: dict, d2: bool, backend: str, flush=None):
    """A captured call (``capture_greedy``) again, on copies of its view
    and usage, through ``backend``; with ``flush`` (a buffer larger than
    the L2 cache) the buffer is written between the copies and the
    launch.  Returns (view, usage)."""
    kw = {k: v for k, v in seen["kw"].items() if k != "backend"}
    view, usage = seen["view"].clone(), seen["usage"].clone()
    if flush is not None:
        flush.fill_(next(_FILLS))
    return getattr(ops, "greedy_run_d2" if d2 else "greedy_run")(
        view, usage, seen["order_pad"], *seen["args"], backend=backend, **kw)


_FILLS = itertools.count(1)


@contextlib.contextmanager
def greedy_form(ops, seen: dict, form: str):
    """The sequential kernels' instantiation ``form`` for this captured
    call: ``"shared"`` as the shapes choose it, or ``"device"`` under the
    largest shared-memory budget at which these shapes take it (local
    colors in device memory).  Checks the choice."""
    n_local_max = seen["args"][0].shape[1]
    mc = seen["kw"]["max_colors"]
    budget = ops._GREEDY_SMEM
    if form == "device":
        slot = ops._SLOT_HEADER + mc // 32 + ops._GREEDY_LIST
        budget = 4 * (mc + ops._GREEDY_CONTROL + ops._GREEDY_MIN_RING * slot
                      + (n_local_max + 1) // 2 - 1)
    old, ops._GREEDY_SMEM = ops._GREEDY_SMEM, budget
    try:
        check(ops._greedy_layout(n_local_max, mc)[0] == form,
              f"the {form} form is not the layout's choice")
        yield ops._greedy_layout(n_local_max, mc)
    finally:
        ops._GREEDY_SMEM = old


def check_greedy(ops, seen: dict, d2: bool, label: str):
    """One captured call: the kernel in both instantiations (local colors
    in shared and in device memory) against its plain version, view and
    usage bitwise, each instantiation's launch counted; for a tile
    strategy also ``select_run[_d2]`` at ``tile=1`` on the same arrays.
    Returns (a note for the log, the error, the plain view and usage)."""
    name = "greedy_run_d2" if d2 else "greedy_run"
    kernel = ops.GREEDY_RUN_D2 if d2 else ops.GREEDY_RUN
    kw, view0, usage0 = seen["kw"], seen["view"], seen["usage"]
    wv, wu = greedy_call(ops, seen, d2, "torch")
    err, rings = 0, []
    for form in ("shared", "device"):
        with greedy_form(ops, seen, form) as (_, ring, _):
            before = kernel.variants.get(form, 0)
            gv, gu = greedy_call(ops, seen, d2, "cuda")
            torch.cuda.synchronize()
        check(kernel.variants.get(form, 0) == before + 1,
              f"{name} {label}: the {form} form did not launch")
        err = max(err, int((gv - wv).abs().max()) + int((gu - wu).abs().max()))
        check(err == 0, f"{name} {label}: the {form} form and plain differ")
        rings.append(f"{form} ring {ring}")
    note = f" in both forms ({', '.join(rings)})"
    if kw["selection"] != ops.LEAST_USED:
        spec = ops.select_run_d2 if d2 else ops.select_run
        tile1 = spec(view0.clone(), seen["order_pad"], *seen["args"],
                     tile=1, backend="cuda", **{k: kw[k] for k in (
                         "first_step", "n_steps", "superstep", "max_colors",
                         "selection", "x")})
        check(torch.equal(tile1, wv),
              f"{name} {label}: differs from select_run at tile=1")
        note += ", select_run at tile=1 equal"
    n_local_max = seen["args"][0].shape[1]
    n_pre = int((view0[:, :n_local_max] > 0).sum())
    n_ghost = int((view0[:, n_local_max:] > 0).sum())
    return (f"{label} (first superstep {kw['first_step']}; {n_pre} local "
            f"and {n_ghost} ghost slots colored before it, usage total "
            f"{int(usage0.sum())}): {int((wv != view0).sum())} colored "
            f"vertices, bitwise{note}"), err, wv, wu


def smi_sample() -> str:
    """The card's SM clock, power draw and power limit, now."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def event_ms(prepare, launch, reps: int) -> float:
    """Mean time of ``launch()`` between CUDA events around it, over
    ``reps`` launches, each after ``prepare()`` (copies, a cache flush)
    and a device-side wait (``torch.cuda._sleep``) long enough for the
    host to enqueue the events and the launch behind it, so the events
    time the kernel and not the host."""
    pairs = []
    for _ in range(reps):
        prepare()
        torch.cuda._sleep(HOST_COVER_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        launch()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / reps


def run_readings(base, launch, reset=None) -> list[float]:
    """``GREEDY_READINGS`` readings of one launch's time (the mean of
    ``GREEDY_LAUNCHES`` launches each, by CUDA events: ``event_ms``), each
    on a fresh copy of ``base`` (``launch(copy)``), after ``reset()`` and
    with the L2 cache flushed, outside the events — rows 5/5b's method."""
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32,
                        device=base.device)
    held = {}

    def prepare():
        held["view"] = base.clone()
        if reset is not None:
            reset()
        flush.fill_(next(_FILLS))

    prepare()
    launch(held["view"])  # warm
    return [event_ms(prepare, lambda: launch(held["view"]), GREEDY_LAUNCHES)
            for _ in range(GREEDY_READINGS)]


def greedy_readings(ops, seen: dict, d2: bool, flush) -> list[float]:
    """``GREEDY_READINGS`` readings of the kernel's time per launch (the
    mean of ``GREEDY_LAUNCHES`` launches each, by CUDA events:
    ``event_ms``) on a captured call; with ``flush`` the L2 cache is
    flushed before every launch, outside the events."""
    name = "greedy_run_d2" if d2 else "greedy_run"
    kw = {k: v for k, v in seen["kw"].items() if k != "backend"}
    fn = getattr(ops, name)
    copies = {}

    def prepare():
        copies["view"] = seen["view"].clone()
        copies["usage"] = seen["usage"].clone()
        if flush is not None:
            flush.fill_(next(_FILLS))

    def launch():
        fn(copies["view"], copies["usage"], seen["order_pad"], *seen["args"],
           backend="cuda", **kw)

    prepare()
    launch()  # warm
    return [event_ms(prepare, launch, GREEDY_LAUNCHES)
            for _ in range(GREEDY_READINGS)]


def spread_note(ms: list[float]) -> str:
    return (f"median {statistics.median(ms):.4f} ms, spread "
            f"{max(ms) / min(ms):.3f}x ({', '.join(f'{m:.4f}' for m in ms)})")


def phase_greedy(ops, calls: dict, d2: bool, label: str) -> dict:
    """The sequential kernel on the path's own runs (``capture_greedy``):
    each captured call held against its plain version in both
    instantiations (``check_greedy``); round 0's first run timed with the
    L2 cache flushed before every launch and without, and in the
    device-memory form (flushed), by CUDA events, beside the plain
    version and its bytes bound, with the card's clock and power sampled
    after each set.  Returns the kernel's time per
    launch (the flushed median by events), the plain version's device
    time, the bound and the error."""
    name = "greedy_run_d2" if d2 else "greedy_run"
    checked = {which: check_greedy(ops, seen, d2, which)
               for which, seen in calls.items()}
    seen = calls["round 0 first"]
    _, err, wv, wu = checked["round 0 first"]
    kw, view0, usage0 = seen["kw"], seen["view"], seen["usage"]
    nbrs = seen["args"][:-2]
    P, n_slots = view0.shape
    S = kw["superstep"]
    # usage: 8 B (read, write) per entry the run changed; Least-Used also
    # scans its whole row once
    n_changed = int((wu != usage0).sum())
    least_used = kw["selection"] == ops.LEAST_USED
    usage_bytes = 8 * n_changed + (4 * usage0.numel() if least_used else 0)
    b, by, n_act = run_bound(
        view0, wv, nbrs, visited=P * kw["n_steps"] * S,
        sentinel=n_slots - 1, speculative=True,
        random_x=kw["selection"] == ops.RANDOM_X, extra_bytes=usage_bytes)
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32,
                        device=view0.device)
    flushed = greedy_readings(ops, seen, d2, flush)
    smi_flushed = smi_sample()
    warm = greedy_readings(ops, seen, d2, None)
    smi_warm = smi_sample()
    with greedy_form(ops, seen, "device") as (_, ring, _):
        device_form = greedy_readings(ops, seen, d2, flush)
    smi_device = smi_sample()
    del flush
    ms = statistics.median(flushed)
    t = dict(ms=ms,
             plain_ms=device_ms(lambda: greedy_call(ops, seen, d2, "torch"),
                                1, skip="Memcpy", warm=False),
             bound=b, by=by, err=err)
    per_vertex = lambda m: m * 1e6 / (n_act / P)

    def reading(r: list[float], smi: str) -> str:
        return (f"{spread_note(r)}, {per_vertex(statistics.median(r)):.1f} "
                f"ns per vertex per shard [clocks.sm, power.draw, "
                f"power.limit: {smi}]")

    for note, *_ in checked.values():
        print(f"  {name} {label} {note}")
    print(f"  {name} {label} timed on round 0's first run ({P} shards x "
          f"{kw['n_steps']} supersteps of {S} positions, {n_act} colored "
          f"vertices, {n_act / P:.1f} per shard), time per launch by CUDA "
          f"events, {GREEDY_READINGS} readings of {GREEDY_LAUNCHES} "
          f"launches each:"
          f"\n    L2 flushed ({FLUSH_BYTES >> 20} MB written before each "
          f"launch): {reading(flushed, smi_flushed)}"
          f"\n    not flushed: {reading(warm, smi_warm)}; flushed / not "
          f"flushed {ms / statistics.median(warm):.3f}"
          f"\n    device-memory form (ring {ring}), L2 flushed: "
          f"{reading(device_form, smi_device)}"
          f"\n    plain {t['plain_ms']:.4f} ms device, bound {b:.4f} ms "
          f"({by}; {n_changed} usage entries changed; the vertex-to-vertex "
          f"chain is not in it), {ms / b:.1f}x the bound", flush=True)
    return t


def counted(ops, fn):
    """``fn()`` with every launch count set to 0 just before and read just
    after; returns (its result, the counts, its wall seconds)."""
    for k in ops.KERNELS:
        k.reset()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    return out, {k.name: k.launches for k in ops.KERNELS}, wall


def check_valid(core, g, pg, view, distance: int, what: str) -> dict:
    st = core.check_coloring(g, core.colors_from_views(pg, view),
                             distance=distance)
    check(st["valid"], f"{what}: distance-{distance} coloring invalid: {st}")
    return st


def phase_rand_pipeline(core, ops, dev, g, pg, order) -> None:
    """Phase 7a: the ND-RAND%2^i schedule through ``pipeline_sim``."""
    from repro_torch.core import presets
    cfg = dataclasses.replace(
        presets.pipeline_config(presets.quality(x=10), n_iters=MAIN_K),
        rand_pow2=True)
    (view, res), launches, _ = counted(
        ops, lambda: core.pipeline_sim(pg, order, cfg, device=dev))
    st = check_valid(core, g, pg, view, 1, "ND-RAND%2^i")
    perms = [h["perm"] for h in res["history"]]
    want = [core.schedule_for_iteration(it, rand_pow2=True)
            for it in range(1, MAIN_K + 1)]
    check(perms == want, f"ND-RAND%2^i ran {perms}, want {want}")
    colors = [res["color"]["n_colors_distinct"]] + [
        h["n_colors_distinct"] for h in res["history"]]
    check(all(b <= a for a, b in zip(colors, colors[1:])),
          f"recoloring raised the color count: {colors}")
    check(launches["select_run"] > 0 and launches["conflict_frontier"] > 0
          and launches["greedy_run"] == 0,
          f"ND-RAND%2^i launches {launches}")
    warm = [core.pipeline_sim(pg, order, cfg, device=dev)[1]["seconds"]
            for _ in range(WARM_RUNS)]
    median = {k: statistics.median(w[k] for w in warm) for k in warm[0]}
    print(f"  7a ND-RAND%2^i (quality preset, K={MAIN_K}, RAND at "
          f"iterations {[i + 1 for i, p in enumerate(perms) if p == 'rand']})"
          f": colors {colors}, valid {st['valid']}; cold {stage_seconds(res)}"
          f"; warm median of {WARM_RUNS}: "
          + ", ".join(f"{k} {v:.4f} s" for k, v in median.items())
          + f"; launches {launches}", flush=True)


def phase_sequential(core, ops, dev, g, pg, order, cfg, label,
                     warm: bool) -> tuple[dict, dict]:
    """One counted ``color_graph_sim`` run of the sequential path: valid at
    the config's distance, ``greedy_run[_d2]`` launched and ``select_run``
    not.  With ``warm``, the color stage ``WARM_RUNS`` times more on
    device-resident arrays (median wall).  Returns (view, stats,
    launches)."""
    d2 = cfg.distance == 2
    name = "greedy_run_d2" if d2 else "greedy_run"
    (view, st), launches, wall = counted(
        ops, lambda: core.color_graph_sim(pg, order, cfg, device=dev))
    check_valid(core, g, pg, view, cfg.distance, label)
    check(launches[name] > 0, f"{label}: {name} never launched")
    forms = dict((ops.GREEDY_RUN_D2 if d2 else ops.GREEDY_RUN).variants)
    check(forms == {"shared": launches[name]},
          f"{label}: {name} launched {forms}, want the shared form only")
    check(launches["select_run"] == 0 and launches["select_run_d2"] == 0,
          f"{label}: a select run kernel launched on the sequential path")
    frontier = "conflict_frontier_d2" if d2 else "conflict_frontier"
    line = (f"  {label}: colors {st['n_colors_distinct']}, rounds "
            f"{st['n_rounds']}, exchanges {st['n_exchanges']}; "
            f"color_graph_sim cold {wall:.4f} s (to_device included); "
            f"launches {name} {launches[name]} (forms {forms}), {frontier} "
            f"{launches[frontier]}")
    if warm:
        from repro_torch import rng
        rcfg = core.resolve_cfg(pg, cfg)
        arrs = core.to_device(pg, dev, sparse=rcfg.scheme == core.SPARSE)
        order_t = torch.as_tensor(order, device=dev)
        walls = []
        stage = lambda: core.color_shards(arrs, order_t, rng.key(cfg.seed),
                                          rcfg)
        for _ in range(WARM_RUNS):
            t = time.perf_counter()
            stage()
            walls.append(time.perf_counter() - t)
        busy = device_ms(stage, 1, warm=False) / 1e3
        mine = device_ms(stage, 1, name, warm=False, per_call=None) / 1e3
        wall = statistics.median(walls)
        del arrs
        line += (f"; color stage warm median of {WARM_RUNS} {wall:.4f} s, "
                 f"device time {busy:.4f} s (profiled repeat), of it {name} "
                 f"{mine:.4f} s; device idle {1 - busy / wall:.3f}")
    print(line, flush=True)
    return view, st, launches


def phase_variants(core, ops, dev, main, d2_cross):
    """Phase 7: the paper's variant paths (a)–(e).  Returns the sequential
    kernels' launches and measured numbers for the kernels line."""
    g, pg, order, view3 = main
    t0 = time.perf_counter()
    phase_rand_pipeline(core, ops, dev, g, pg, order)
    phase("7a ND-RAND%2^i pipeline", t0)
    measured, launches = {}, {"greedy_run": 0, "greedy_run_d2": 0}
    for sel in (ops.FIRST_FIT, ops.LEAST_USED):
        t0 = time.perf_counter()
        cfg = core.ColorConfig(selection=sel, parallel_chunk=False)
        _, _, ln = phase_sequential(core, ops, dev, g, pg, order, cfg,
                                    f"7b sequential {sel}", warm=True)
        launches["greedy_run"] += ln["greedy_run"]
        t = phase_greedy(ops, capture_greedy(core, ops, pg, order, cfg, dev),
                         False, f"7d {sel}")
        if sel == ops.FIRST_FIT:
            measured["greedy_run"] = t
        phase(f"7b/7d sequential {sel}", t0)
    t0 = time.perf_counter()
    (view, st), ln, wall = counted(ops, lambda: core.arc_sim(
        pg, view3, core.RAND, core.RecolorConfig(),
        core.ColorConfig(superstep=512), device=dev))
    check_valid(core, g, pg, view, 1, "aRC")
    print(f"  7c aRC (RAND rank of phase 3's coloring, First Fit tiles): "
          f"colors {st['n_colors_distinct']}, rounds {st['n_rounds']}, "
          f"exchanges {st['n_exchanges']}, n_out_of_range "
          f"{st['n_out_of_range']}; wall {wall:.4f} s (to_device included); "
          f"launches select_run {ln['select_run']}, conflict_frontier "
          f"{ln['conflict_frontier']}", flush=True)
    check(ln["select_run"] > 0, "aRC never launched select_run")
    phase("7c aRC", t0)
    g2, pg2, order2 = d2_cross
    for sel in (ops.FIRST_FIT, ops.LEAST_USED):
        t0 = time.perf_counter()
        cfg = core.ColorConfig(selection=sel, parallel_chunk=False,
                               distance=2)
        view, st, ln = phase_sequential(core, ops, dev, g2, pg2, order2,
                                        cfg, f"7e sequential D2 {sel}",
                                        warm=False)
        launches["greedy_run_d2"] += ln["greedy_run_d2"]
        t = time.perf_counter()
        plain = core.color_graph_sim(
            pg2, order2, dataclasses.replace(cfg, backend="torch"),
            device=dev)
        check(torch.equal(view, plain[0]) and st == plain[1],
              f"7e D2 {sel}: kernel and plain colorings differ")
        print(f"  7e D2 {sel}: the plain coloring "
              f"({time.perf_counter() - t:.3f} s) equals the kernels' "
              "bitwise", flush=True)
        t = phase_greedy(ops, capture_greedy(core, ops, pg2, order2, cfg,
                                             dev), True, f"7e {sel}")
        if sel == ops.FIRST_FIT:
            measured["greedy_run_d2"] = t
        phase(f"7e sequential D2 {sel}", t0)
    return launches, measured


# -- phase 8: batched multi-graph coloring ------------------------------------

def capture_largest_recolor(ops, run, d2: bool, frozen: bool = False) -> dict:
    """The recolor-mode run launch of ``run()`` with the most chunks: its
    arguments and a copy of the view it started from.  ``frozen=True``
    takes only launches in which some lane is frozen or empty (an
    all-zero ``class_chunks`` row) while another colors."""
    name = "recolor_run_d2" if d2 else "recolor_run"
    real = getattr(ops, name)
    best = {}

    def note(view, *args, **kw):
        chunks = args[-1][:, kw["first_class"]:kw["last_class"] + 1]
        n = int(chunks.sum())
        idle = bool((args[-1].sum(dim=1) == 0).any()) if frozen else True
        if idle and n > best.get("n", -1):
            best.update(n=n, view=view.clone(), args=args, kw=kw)
        return real(view, *args, **kw)

    setattr(ops, name, note)
    try:
        run()
    finally:
        setattr(ops, name, real)
    check(bool(best), f"the batch made no {name} call")
    return best


def check_recolor_lanes(ops, best: dict, d2: bool, label: str) -> dict:
    """The recolor-mode run kernel with per-lane ``class_chunks`` ``(L,
    n_cls)`` against its plain version on the batch's own largest run
    (``capture_largest_recolor``), bitwise; its time per launch by CUDA
    events with the L2 flushed, and the plain version's device time."""
    name = "select_run_d2" if d2 else "select_run"
    fn = ops.recolor_run_d2 if d2 else ops.recolor_run
    kw = {k: v for k, v in best["kw"].items() if k != "backend"}
    call = lambda v, backend: fn(v, *best["args"], backend=backend, **kw)
    base = best["view"]
    got, want = call(base.clone(), "cuda"), call(base.clone(), "torch")
    err = int((got - want).abs().max())
    check(err == 0, f"{label} {name} (recolor, per-lane chunks): kernel and "
          "plain views differ")
    ms = run_readings(base, lambda v: call(v, "cuda"))
    plain = device_ms(lambda: call(base.clone(), "torch"), 1, skip="Memcpy")
    chunks = best["args"][-1][:, kw["first_class"]:kw["last_class"] + 1]
    L = chunks.shape[0]
    print(f"  {label} {name} recolor run, classes {kw['first_class']}-"
          f"{kw['last_class']} ({L} lanes of {base.shape[0] // L} shards; "
          f"chunks of {kw['chunk']} rows per lane "
          f"{chunks.sum(dim=1).tolist()}): bitwise equal to the plain "
          f"version; kernel {statistics.median(ms):.4f} ms per launch by CUDA "
          f"events, L2 flushed ({spread_note(ms)}), plain {plain:.4f} ms "
          "device", flush=True)
    return dict(ms=statistics.median(ms), plain_ms=plain, err=err)


def drive_bucket(core, ops, dev, graphs, pgs, bucket, cfg, label) -> None:
    """One bucket of ``color_many`` at full size: a counted cold run (every
    launch count set to 0 just before it and read just after); each lane
    valid at the config's distance and bitwise its solo ``pipeline_sim``
    on the card (padded member, the bucket's resolved config, the lane's
    folded keys), each solo run counted too; with ``B >= 2`` lanes, fewer
    launches of the path's kernels than the solo runs together.  Then the
    warm runs (median wall), one profiled run (device time, idle share),
    and the lane forms of the frontier and recolor-run kernels against
    their plain versions on the bucket's own first repair and largest
    recolor run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import rng
    d2 = cfg.color.distance == 2
    kernels = (("select_run_d2", "conflict_frontier_d2") if d2
               else ("select_run", "conflict_frontier"))
    sig = core.bucket_signature(bucket, cfg)
    bcfg = sig.cfg
    m0 = bucket.members[0]
    rounds = len(bucket.plan_static[0])
    print(f"  {label} bucket: {bucket.B} graphs (inputs {list(bucket.indices)})"
          f" in {sig.batch} lanes x P={bucket.P}; n_local_max "
          f"{m0.n_local_max}, maxd {m0.maxd}, maxd2 {m0.maxd2}, max_ghost "
          f"{m0.max_ghost}; scheme {bcfg.recolor.scheme}, union schedule "
          f"{rounds} rounds", flush=True)
    run = lambda: core.color_many(pgs, cfg, buckets=[bucket], pad_batch=True,
                                  device=dev)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    res, launches, cold = counted(ops, run)
    peak = torch.cuda.max_memory_allocated(dev)
    for name in kernels:
        check(launches[name] > 0, f"{label}: {name} never launched")
    for name in ("color_select", "color_select_d2", "conflict",
                 "conflict_d2"):
        check(launches[name] == 0, f"{label}: the tile kernel {name} "
              "launched on the path")
    solo = {name: 0 for name in launches}
    solo_cold = solo_warm = 0.0
    colors = []
    for j, gi in enumerate(bucket.indices):
        lane = res[gi]
        st = core.check_coloring(graphs[gi], lane["colors"],
                                 distance=bcfg.color.distance)
        check(st["valid"], f"{label}: graph {gi} invalid: {st}")
        m = bucket.members[j]
        order = core.compute_order(m, core.ordering.INTERNAL_FIRST)
        keys = dict(color_key=rng.fold_in(rng.key(bcfg.color.seed), gi),
                    recolor_key=rng.fold_in(rng.key(bcfg.seed), gi))
        solo_run = lambda: core.pipeline_sim(m, order, bcfg, device=dev,
                                             **keys)
        (view, r), ln, wall = counted(ops, solo_run)
        check(torch.equal(view, lane["view"]) and r["color"] == lane["color"]
              and r["history"] == lane["history"]
              and r["n_iters_run"] == lane["n_iters_run"],
              f"{label}: graph {gi} differs from its solo run")
        for name, n in ln.items():
            solo[name] += n
        solo_cold += wall
        warm = solo_run()[1]["seconds"]
        solo_warm += warm["color"] + warm["recolor"]
        colors.append(r["history"][-1]["n_colors_distinct"] if r["history"]
                      else r["color"]["n_colors_distinct"])
        del view
    mine = {k: (launches[k], solo[k]) for k in kernels}
    if bucket.B >= 2:
        for name, (n, n_solo) in mine.items():
            check(n < n_solo, f"{label}: {name} launched {n} times batched, "
                  f"{n_solo} solo")
    walls = []
    for _ in range(WARM_RUNS):
        t = time.perf_counter()
        run()
        torch.cuda.synchronize(dev)
        walls.append(time.perf_counter() - t)
    warm = statistics.median(walls)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize(dev)
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events) / 1e6
    h2d = sum(e.self_device_time_total for e in events
              if "Memcpy" in e.key) / 1e6
    ours = {k: sum(e.self_device_time_total for e in events
                   if k + "_kernel" in e.key) / 1e6 for k in kernels}
    loop = busy - h2d
    print(f"  {label} colors per lane {colors}, every lane valid and bitwise "
          f"its solo run on the card")
    print(f"  {label} walls: color_many cold {cold:.4f} s (arrays to the "
          f"device included) against {solo_cold:.4f} s for the "
          f"{bucket.B} solo pipeline_sim runs together (each its to_device "
          f"included); warm median of {WARM_RUNS} {warm:.4f} s "
          f"({', '.join(f'{w:.4f}' for w in walls)}) against "
          f"{solo_warm:.4f} s of solo color+recolor stages (warm); peak "
          f"device memory {peak / 2**30:.3f} GiB")
    print(f"  {label} launches batched / solo together: "
          + ", ".join(f"{k} {n} / {n_solo}" for k, (n, n_solo) in mine.items())
          + f"; all kernels {launches}")
    print(f"  {label} profiled warm run: device busy {busy:.4f} s, of it "
          f"host->device copies {h2d:.4f} s, "
          + ", ".join(f"{k} {v:.4f} s" for k, v in ours.items())
          + f"; device idle {1 - loop / warm:.3f} of the warm median wall",
          flush=True)
    phase_frontier(ops, capture_first_repair(run), d2)
    check_recolor_lanes(ops, capture_largest_recolor(ops, run, d2), d2, label)
    del res
    bucket.__dict__.pop("_device_arrays", None)
    torch.cuda.empty_cache()


def phase_many(core, ops, dev, d2_cross) -> list:
    """Phase 8: ``color_many`` at full size — a D1 bucket pair (8 x
    ``rmat_good(17, 8)`` and 4 x ``rmat_bad(17, 8)`` on P=16, the quality
    preset, K=8, ``pad_batch=True``) and a D2 bucket (phase 6's
    ``grid3d(32, 32, 32)`` halo-2 partition and ``grid3d(32, 32, 24)``, the
    D2 preset, K=8), each bucket driven by ``drive_bucket``.  Returns the
    8 RMAT-Good graphs (phase 10 colors them again)."""
    from repro_torch.core import presets
    t = time.perf_counter()
    graphs = ([core.rmat.rmat_good(MANY_SCALE, 8, seed=s) for s in MANY_GOOD]
              + [core.rmat.rmat_bad(MANY_SCALE, 8, seed=s)
                 for s in MANY_BAD])
    t_gen = time.perf_counter() - t
    pgs = [core.partition_graph(g, MANY_P) for g in graphs]
    buckets = core.bucket_graphs(pgs)
    t_part = time.perf_counter() - t - t_gen
    print(f"  {len(graphs)} graphs rmat_good/rmat_bad({MANY_SCALE}, 8): "
          f"{sum(g.m for g in graphs)} edges in all, P={MANY_P}; generate "
          f"{t_gen:.3f} s, partition and bucket {t_part:.3f} s; "
          f"{len(buckets)} buckets of {[b.B for b in buckets]}", flush=True)
    check(len(buckets) >= 2, f"the batch spans {len(buckets)} bucket(s)")
    cfg = presets.pipeline_config(presets.quality(x=10), n_iters=MANY_K)
    # the padded members stand in for their originals (same local slots),
    # and a bucket's host arrays go once it is done: host memory holds
    # one copy of one bucket at a time
    for bucket in buckets:
        for gi, m in zip(bucket.indices, bucket.members):
            pgs[gi] = m
    for bi in range(len(buckets)):
        bucket, buckets[bi] = buckets[bi], None
        t0 = time.perf_counter()
        drive_bucket(core, ops, dev, graphs, pgs, bucket, cfg, f"8a.{bi}")
        phase(f"8a D1 bucket {bi} ({bucket.B} graphs)", t0)
        for gi in bucket.indices:
            pgs[gi] = None
        del bucket
    t0 = time.perf_counter()
    g6, pg6, _ = d2_cross
    g2 = core.rmat.grid3d(*D2_MANY_GRID)
    pgs = [pg6, core.partition_graph(g2, D2_P, halo=2)]
    buckets = core.bucket_graphs(pgs)
    check([b.B for b in buckets] == [2], f"the D2 graphs bucket as "
          f"{[b.B for b in buckets]}")
    print(f"  D2 graphs grid3d{D2_CROSS_GRID} (phase 6's partition) and "
          f"grid3d{D2_MANY_GRID}, halo 2, P={D2_P}; partition "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    drive_bucket(core, ops, dev, [g6, g2], pgs, buckets[0],
                 d2_config(presets, MANY_K), "8b")
    phase("8b D2 bucket (2 graphs)", t0)
    return graphs[:len(MANY_GOOD)]


# -- phase 9: the continuous-batching service --------------------------------

def serve_solo(core, ops, r: dict, jid: int, dev) -> dict:
    """An engine result against the counted solo ``pipeline_sim`` of its
    engine-padded member on the card, with the request-folded keys: colors,
    history and iteration count bitwise.  Returns the solo run's
    launches."""
    from repro_torch import rng
    m, cfg = r["member"], r["cfg"]
    (view, solo), launches, _ = counted(ops, lambda: core.pipeline_sim(
        m, core.compute_order(m, core.ordering.INTERNAL_FIRST), cfg,
        color_key=rng.fold_in(rng.key(cfg.color.seed), jid),
        recolor_key=rng.fold_in(rng.key(cfg.seed), jid), device=dev))
    colors = m.gather_global_colors(view.cpu().numpy()[:, :m.n_local_max])
    check(np.array_equal(colors, r["colors"])
          and solo["history"] == r["history"]
          and solo["n_iters_run"] == r["n_iters_run"],
          f"request {jid} differs from its solo run on the card")
    return launches


def check_served(core, ops, out, n: int, label: str, dev) -> dict:
    """Every request of a scripted run completed, valid (``validate=True``
    checked it on the host) and, on the engine route, bitwise its solo
    run on the card.  Returns the solo runs' launches together."""
    check(not out.shed and not out.failed and len(out.results) == n,
          f"{label}: {len(out.results)} of {n} results, shed {out.shed}, "
          f"failed {out.failed}")
    solo = {}
    for jid, r in sorted(out.results.items()):
        check("error" not in r and r["check"]["valid"],
              f"{label}: request {jid} invalid: {r.get('check')}")
        if r["route"] == "engine":
            for k, v in serve_solo(core, ops, r, jid, dev).items():
                solo[k] = solo.get(k, 0) + v
    return solo


def pulled(launches: dict) -> dict:
    """Launch counts without ``exchange_push``: a one-device run pushes its
    recoloring exchanges, a mesh's ``MeshExchange`` pulls them."""
    return {k: v for k, v in launches.items() if k != "exchange_push"}


def serve_launches(launches: dict, names) -> str:
    return ", ".join(f"{k} {launches[k]}" for k in names)


def serve_leg_bitwise(core, ops, S, H, dev, graphs) -> None:
    """Leg (a): 12 requests, one arrival per tick on a ``FakeClock``,
    continuous mode: the mix's first 6 graphs, each requested twice in a
    row (a request lives 1-2 polls at this config, and the mix turns class
    at every request, so only a repeat shares an engine with a running
    lane); every result valid and bitwise its solo run, a request admitted
    beside a running lane of its engine, and the recolor-mode lane form of
    ``select_run`` held bitwise against its plain version on the engine's
    largest step run with a frozen or empty lane."""
    graphs = [g for g in graphs[:SERVE_BITWISE // 2] for _ in range(2)]
    svc = S.ColoringService(
        P=SERVE_P, cfg=S.default_config(), validate=True, device=dev,
        clock=S.FakeClock(), serve=S.ServeConfig(
            lanes=SERVE_LANES, chunk_iters=SERVE_CHUNK, solo_warm=False))
    script = [H.Arrival(float(t), g) for t, g in enumerate(graphs)]
    held = {}

    def drive():
        held["out"] = H.run_script(svc, script)

    best, launches, wall = counted(
        ops, lambda: capture_largest_recolor(ops, drive, False, frozen=True))
    out = held["out"]
    mid = H.mid_flight_admissions(out.poll_log)
    st = svc.stats()
    print(f"  9a {len(graphs)} requests (6 graphs, each twice in a row), one "
          f"per tick, lanes {SERVE_LANES}, chunk {SERVE_CHUNK}: {out.polls} "
          f"polls, {mid} admissions beside a running lane of the engine, "
          f"{svc._engine_seq} engines made ({st['engines']} kept), routes "
          f"lane {st['lane']}; (engine, lane, request) per poll "
          f"{out.poll_log}; wall {wall:.3f} s (with the capture's reads)",
          flush=True)
    for name in ("select_run", "conflict_frontier"):
        check(launches[name] > 0, f"9a: {name} never launched")
    for name in ("color_select", "conflict", "color_select_d2",
                 "conflict_d2"):
        check(launches[name] == 0, f"9a: the tile kernel {name} launched")
    check(mid > 0, "9a: no request was admitted beside a running lane")
    solo = check_served(core, ops, out, len(graphs), "9a", dev)
    print(f"  9a colors {[out.results[j]['n_colors'] for j in sorted(out.results)]}"
          f", iterations "
          f"{[out.results[j]['n_iters_run'] for j in sorted(out.results)]}; "
          f"every result valid and bitwise its solo pipeline_sim on the card")
    print(f"  9a launches: service {serve_launches(launches, SERVE_KERNELS)};"
          f" solo runs together {serve_launches(solo, SERVE_KERNELS)}")
    check_recolor_lanes(ops, best, False, "9a engine step,")
    del svc, out, best
    gc.collect()
    torch.cuda.empty_cache()


@contextlib.contextmanager
def serve_timers(S):
    """Host wall seconds spent in the service's parts (partition memo
    ``_entry``, engine ``admit``, ``step`` and ``drain``, flush mode's
    ``_dispatch`` and ``_finish``), summed while the block runs; each part
    ends in a device read or runs on the host, so its wall holds its
    device work too."""
    owners = {"_entry": S.ColoringService, "admit": S._Engine,
              "step": S._Engine, "drain": S._Engine,
              "_dispatch": S.ColoringService, "_finish": S.ColoringService}
    spent = dict.fromkeys(owners, 0.0)
    real = {k: getattr(owners[k], k) for k in spent}

    def timed(name):
        def run(*args, **kw):
            t = time.perf_counter()
            try:
                return real[name](*args, **kw)
            finally:
                spent[name] += time.perf_counter() - t
        return run

    for k in spent:
        setattr(owners[k], k, timed(k))
    try:
        yield spent
    finally:
        for k in spent:
            setattr(owners[k], k, real[k])


def serve_job_seconds(core, S, dev, graphs) -> float:
    """The mean service time of a fresh request, alone: the service's
    host work on a graph it has not seen (partition, bucket, orders:
    ``_entry``) and a ``pipeline_sim`` of its padded member (arrays to
    the device included), over the mix's first 6 graphs."""
    probe = S.ColoringService(P=SERVE_P, cfg=S.default_config(), device=dev)
    walls = []
    for g in graphs[:6]:
        t = time.perf_counter()
        e = probe._entry(g)
        core.pipeline_sim(e.member, e.order, probe.cfg, device=dev)
        torch.cuda.synchronize(dev)
        walls.append(time.perf_counter() - t)
    print(f"  9b a fresh request alone (partition + pipeline_sim), first 6 "
          f"graphs: {', '.join(f'{w:.4f}' for w in walls)} s, mean "
          f"{statistics.mean(walls):.4f} s", flush=True)
    return statistics.mean(walls)


def serve_leg_open_loop(core, ops, S, H, dev, graphs) -> None:
    """Leg (b): the requests on a hybrid clock (scripted Poisson arrivals
    whose mean gap is a fresh request's service time alone,
    ``serve_job_seconds``: load 1; each poll advances the clock by its
    measured wall seconds), in continuous and in flush mode: latency
    p50/p99 (arrival to the end of the poll that completed it), graphs/s,
    polls, engines, routes, launches against the solo runs together,
    device idle share of the polls (device time from a trace of the
    device alone), peak device memory."""

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    gap = serve_job_seconds(core, S, dev, graphs)
    t_arr = np.cumsum(np.random.default_rng(SERVE_SEED + 1).exponential(
        gap, size=len(graphs)))
    script = [H.Arrival(float(t), g) for t, g in zip(t_arr, graphs)]
    solo = None
    for mode in ("continuous", "flush"):
        svc = S.ColoringService(
            P=SERVE_P, cfg=S.default_config(), validate=True, device=dev,
            clock=S.FakeClock(), serve=S.ServeConfig(
                mode=mode, lanes=SERVE_LANES, chunk_iters=SERVE_CHUNK,
                solo_warm=False))
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        with profile(activities=[ProfilerActivity.CUDA]) as prof, \
                serve_timers(S) as spent:
            out, launches, wall = counted(
                ops, lambda: H.run_script(svc, script, poll_cost=None))
        peak = torch.cuda.max_memory_allocated(dev)
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA) / 1e6
        # the flush mode's batch results carry no member: they are
        # checked valid; the engine results also bitwise their solo runs
        served = check_served(core, ops, out, len(graphs), f"9b {mode}", dev)
        solo = solo or served
        lats = sorted(out.done_t[j] - out.submit_t[j] for j in out.results)
        span = max(out.done_t.values()) - min(out.submit_t.values())
        polls_s = sum(out.poll_s)
        st = svc.stats()
        print(f"  9b {mode}: {len(graphs)} requests, Poisson arrivals of "
              f"mean gap {gap:.4f} s, latency p50 "
              f"{lats[len(lats) // 2]:.4f} s, p99 "
              f"{lats[min(len(lats) - 1, int(len(lats) * 0.99))]:.4f} s, "
              f"{len(lats) / span:.3f} graphs/s over {span:.3f} s; "
              f"{out.polls} polls ({polls_s:.3f} s of poll walls, wall "
              f"{wall:.3f} s), engines made {svc._engine_seq}, routes solo "
              f"{st['solo']} lane {st['lane']} batch {st['batch']}; device "
              f"busy {busy:.4f} s, idle {1 - busy / polls_s:.3f} of the "
              f"polls; peak device memory {peak / 2**30:.3f} GiB; of the "
              f"poll walls: partition memo (_entry) {spent['_entry']:.3f} s, "
              f"admit {spent['admit']:.3f} s, engine steps "
              f"{spent['step']:.3f} s, drains {spent['drain']:.3f} s, "
              f"color_many waves {spent['_dispatch']:.3f} s, wave results "
              f"(_finish) {spent['_finish']:.3f} s, the rest "
              f"{polls_s - sum(spent.values()):.3f} s", flush=True)
        print(f"  9b {mode} launches: {serve_launches(launches, SERVE_KERNELS)}"
              f"; solo runs together {serve_launches(solo, SERVE_KERNELS)}")
        del svc, out, prof
        gc.collect()
        torch.cuda.empty_cache()


def serve_leg_d2(core, ops, S, H, dev) -> None:
    """Leg (c): 4 stencils at distance 2 (halo 2), K=4, 2 lanes: every
    result valid at distance 2 and bitwise its solo run on the card."""
    t = time.perf_counter()
    graphs = [core.rmat.grid3d(*d) for d in SERVE_D2_GRIDS]
    svc = S.ColoringService(
        P=SERVE_P, cfg=S.default_config(distance=2, n_iters=SERVE_D2_K),
        validate=True, device=dev, clock=S.FakeClock(),
        serve=S.ServeConfig(lanes=SERVE_D2_LANES, chunk_iters=SERVE_CHUNK,
                            solo_warm=False))
    script = [H.Arrival(float(t), g) for t, g in enumerate(graphs)]
    out, launches, wall = counted(ops, lambda: H.run_script(svc, script))
    for name in ("select_run_d2", "conflict_frontier_d2"):
        check(launches[name] > 0, f"9c: {name} never launched")
    solo = check_served(core, ops, out, len(graphs), "9c", dev)
    print(f"  9c D2 grid3d {list(SERVE_D2_GRIDS)} halo 2, K={SERVE_D2_K}, "
          f"lanes {SERVE_D2_LANES}: {out.polls} polls, engines made "
          f"{svc._engine_seq}, colors "
          f"{[out.results[j]['n_colors'] for j in sorted(out.results)]}, "
          f"every result valid at distance 2 and bitwise its solo run on "
          f"the card; {time.perf_counter() - t:.3f} s (service wall "
          f"{wall:.3f} s)")
    print(f"  9c launches: service {serve_launches(launches, SERVE_D2_KERNELS)}"
          f"; solo runs together {serve_launches(solo, SERVE_D2_KERNELS)}",
          flush=True)
    del svc, out


def phase_serve(core, ops, dev) -> list:
    """Phase 9: the continuous-batching service (``ColoringService`` of
    ``repro_torch.launch.serve_coloring``, default config: Random-X X=10,
    ND, K=8, patience 2, max_colors 1024; P=16) through its three legs."""
    from repro_torch.launch import serve_coloring as S
    from repro_torch.launch import serve_harness as H
    t = time.perf_counter()
    graphs = S._traffic(SERVE_TRAFFIC, *SERVE_SCALES, SERVE_SEED)
    print(f"  traffic: {len(graphs)} graphs rmat_er/good/bad in turn, scales "
          f"{SERVE_SCALES[0]}-{SERVE_SCALES[1]}, edge factor 8 "
          f"({[g.n for g in graphs]} vertices); generate "
          f"{time.perf_counter() - t:.3f} s", flush=True)
    t0 = time.perf_counter()
    serve_leg_bitwise(core, ops, S, H, dev, graphs)
    phase("9a service bitwise (FakeClock)", t0)
    t0 = time.perf_counter()
    serve_leg_open_loop(core, ops, S, H, dev, graphs[:SERVE_OPEN_LOOP])
    phase("9b service latency (hybrid clock)", t0)
    t0 = time.perf_counter()
    serve_leg_d2(core, ops, S, H, dev)
    phase("9c service at distance 2", t0)
    phase("9 service total", t)
    return graphs


# -- phase 10: the sharded entry points on a one-rank NCCL world ------------

def nccl_collectives(prof) -> str:
    """The NCCL work of a profiled run: its host-side collective calls and
    its device kernels, by name and count."""
    from torch.autograd import DeviceType
    host, dev = {}, {}
    for e in prof.key_averages():
        if "nccl" in e.key.lower():
            side = dev if e.device_type == DeviceType.CUDA else host
            side[e.key] = side.get(e.key, 0) + e.count
    return f"host calls {host}; device kernels {dev or 'none'}"


def mesh_pipeline(core, ops, dev, M, g) -> dict:
    """10(a): ``pipeline_sharded`` on ``MeshSpec.worker(1)`` against a
    counted ``pipeline_sim`` of the same P=1 partition of phase 3's graph.
    Returns the run's partition, order, config and mesh (phase 11c)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import presets
    t = time.perf_counter()
    pg = core.partition_graph(g, MESH_P)
    order = core.compute_order(pg, core.ordering.INTERNAL_FIRST)
    cfg = presets.pipeline_config(presets.quality(x=10), n_iters=MAIN_K)
    print(f"  10a graph rmat_good({MAIN_SCALE}, 8, seed=1) at P={MESH_P}: "
          f"n_local_max={pg.n_local_max}, maxd={pg.maxd}; partition+order "
          f"{time.perf_counter() - t:.3f} s", flush=True)
    mesh = M.MeshSpec.worker(MESH_P).build()
    (v_sim, r_sim), l_sim, w_sim = counted(
        ops, lambda: core.pipeline_sim(pg, order, cfg, device=dev))
    (v_sh, r_sh), l_sh, w_sh = counted(
        ops, lambda: core.pipeline_sharded(pg, order, cfg, mesh))
    check(torch.equal(v_sim, v_sh) and r_sim["color"] == r_sh["color"]
          and r_sim["history"] == r_sh["history"]
          and r_sim["n_iters_run"] == r_sh["n_iters_run"],
          "10a: pipeline_sharded differs from pipeline_sim")
    st = core.check_coloring(g, core.colors_from_views(pg, v_sh))
    check(st["valid"], f"10a: coloring invalid: {st}")
    check(pulled(l_sh) == pulled(l_sim),
          f"10a: launches {l_sh} sharded, {l_sim} sim")
    for name in ("select_run", "conflict_frontier"):
        check(l_sh[name] > 0, f"10a: {name} never launched")
    del v_sim
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        warm = core.pipeline_sharded(pg, order, cfg, mesh)[1]["seconds"]
        torch.cuda.synchronize(dev)
    hist = r_sh["history"]
    print(f"  10a pipeline_sharded: colors {hist[-1]['n_colors_distinct']} "
          f"after {r_sh['n_iters_run']} iterations, initial "
          f"{r_sh['color']}; bitwise pipeline_sim's (view, color stats, "
          f"history), valid; launches "
          f"{serve_launches(l_sh, SERVE_KERNELS)} (sim the same); walls "
          f"sharded {w_sh:.3f} s ({stage_seconds(r_sh)}), sim {w_sim:.3f} "
          f"s ({stage_seconds(r_sim)}); profiled warm repeat "
          f"{', '.join(f'{k} {v:.3f} s' for k, v in warm.items())}",
          flush=True)
    print(f"  10a NCCL in the profiled repeat: {nccl_collectives(prof)}",
          flush=True)
    return pg, order, cfg, mesh


def mesh_many(core, ops, dev, M, goods) -> None:
    """10(b): ``color_many_sharded`` on ``MeshSpec.coloring(1, batch=1)``
    against ``color_many`` on phase 8's RMAT-Good graphs at P=1."""
    from repro_torch.core import presets
    t = time.perf_counter()
    pgs = [core.partition_graph(g, MESH_P) for g in goods]
    buckets = core.bucket_graphs(pgs)
    check([b.B for b in buckets] == [len(goods)],
          f"10b: the graphs bucket as {[b.B for b in buckets]}")
    print(f"  10b {len(goods)} graphs rmat_good({MANY_SCALE}, 8) at "
          f"P={MESH_P}: one bucket, n_local_max "
          f"{buckets[0].members[0].n_local_max}, maxd "
          f"{buckets[0].members[0].maxd}; partition and bucket "
          f"{time.perf_counter() - t:.3f} s", flush=True)
    cfg = presets.pipeline_config(presets.quality(x=10), n_iters=MANY_K)
    mesh = M.MeshSpec.coloring(MESH_P, batch=1).build()
    sim, l_sim, w_sim = counted(ops, lambda: core.color_many(
        pgs, cfg, buckets=buckets, pad_batch=True, device=dev))
    sh, l_sh, w_sh = counted(ops, lambda: core.color_many_sharded(
        pgs, cfg, mesh, buckets=buckets, pad_batch=True))
    for i, (a, b) in enumerate(zip(sim, sh)):
        check(torch.equal(a["view"], b["view"])
              and np.array_equal(a["colors"], b["colors"])
              and a["color"] == b["color"] and a["history"] == b["history"]
              and a["n_iters_run"] == b["n_iters_run"],
              f"10b: graph {i} differs between color_many_sharded and "
              "color_many")
    check(pulled(l_sh) == pulled(l_sim),
          f"10b: launches {l_sh} sharded, {l_sim} sim")
    print(f"  10b every lane bitwise color_many's; colors "
          f"{[r['history'][-1]['n_colors_distinct'] for r in sh]}; launches "
          f"{serve_launches(l_sh, SERVE_KERNELS)} (sim the same); walls "
          f"sharded {w_sh:.3f} s, sim {w_sim:.3f} s", flush=True)
    buckets[0].__dict__.pop("_device_arrays", None)
    buckets[0].__dict__.pop("_stacked", None)


def mesh_serve(ops, dev, M, graphs) -> None:
    """10(c): phase 9(a)'s script (the mix's first 6 graphs, each twice in
    a row, one per tick, continuous mode) at P=1 through
    ``ColoringService(mesh=MeshSpec.coloring(1, 1))`` and the ``mesh=None``
    service: every result bitwise the same."""

    from repro_torch.launch import serve_coloring as S
    from repro_torch.launch import serve_harness as H
    graphs = [g for g in graphs[:SERVE_BITWISE // 2] for _ in range(2)]
    script = [H.Arrival(float(t), g) for t, g in enumerate(graphs)]
    runs = {}
    for label, mesh in (("mesh=None", None),
                        ("mesh", M.MeshSpec.coloring(MESH_P, 1))):
        svc = S.ColoringService(
            P=MESH_P, cfg=S.default_config(), validate=True, device=dev,
            mesh=mesh, clock=S.FakeClock(), serve=S.ServeConfig(
                lanes=SERVE_LANES, chunk_iters=SERVE_CHUNK, solo_warm=False))
        out, launches, wall = counted(ops, lambda: H.run_script(svc, script))
        check(not out.shed and not out.failed
              and len(out.results) == len(graphs),
              f"10c {label}: {len(out.results)} results, shed {out.shed}, "
              f"failed {out.failed}")
        runs[label] = (out.results, launches, wall, out.polls)
        del svc, out
        gc.collect()
        torch.cuda.empty_cache()
    (ref, l_ref, w_ref, p_ref), (got, l_got, w_got, p_got) = runs.values()
    for jid, r in ref.items():
        g = got[jid]
        check(np.array_equal(r["colors"], g["colors"])
              and r["check"]["valid"] and g["check"]["valid"]
              and all(r[k] == g[k] for k in ("color", "history",
                                             "n_iters_run", "route")),
              f"10c: request {jid} differs between the mesh route and "
              "mesh=None")
    print(f"  10c {len(graphs)} requests at P={MESH_P}, lanes "
          f"{SERVE_LANES}: every result valid and bitwise the mesh=None "
          f"service's; colors {[ref[j]['n_colors'] for j in sorted(ref)]}; "
          f"polls {p_got} (mesh=None {p_ref}); launches mesh "
          f"{serve_launches(l_got, SERVE_KERNELS)}, mesh=None "
          f"{serve_launches(l_ref, SERVE_KERNELS)}; walls {w_got:.3f} s, "
          f"{w_ref:.3f} s", flush=True)


@contextlib.contextmanager
def nccl_world(dev):
    """A one-rank NCCL world on this card (a ``file://`` store in the
    checkout's build directory), torn down on exit."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from repro_torch.launch import mesh as M
    root = Path(__file__).resolve().parent / "build"
    root.mkdir(exist_ok=True)
    store = tempfile.mkdtemp(prefix="nccl-store-", dir=root)
    got = M.init_world(init_method=f"file://{store}/store", rank=0,
                       world_size=1)
    check(got == dev, f"init_world put the rank on {got}, not {dev}")
    try:
        yield M
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)


def phase_mesh(core, ops, dev, M, g, goods, serve_graphs):
    """Phase 10: the sharded entry points on the one-rank world.  Returns
    10(a)'s partition, order, config and mesh."""
    t = time.perf_counter()
    t0 = time.perf_counter()
    run10a = mesh_pipeline(core, ops, dev, M, g)
    phase(f"10a pipeline_sharded rmat_good({MAIN_SCALE}) P={MESH_P}", t0)
    t0 = time.perf_counter()
    mesh_many(core, ops, dev, M, goods)
    phase(f"10b color_many_sharded rmat_good({MANY_SCALE}) x "
          f"{len(goods)} P={MESH_P}", t0)
    t0 = time.perf_counter()
    mesh_serve(ops, dev, M, serve_graphs)
    phase(f"10c ColoringService(mesh) P={MESH_P}", t0)
    phase("10 sharded entry points total (one-rank NCCL world)", t)
    return run10a


def load_example(name: str):
    import importlib.util
    path = Path(__file__).resolve().parent / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def tools_examples(core, dev) -> None:
    """11(a): the three examples on the card at their own sizes."""
    from contextlib import redirect_stdout
    from io import StringIO
    quiet = StringIO()
    t = time.perf_counter()
    with redirect_stdout(quiet):
        q = load_example("torch_quickstart").main(device=dev)
    check(q["check"]["valid"], f"11a quickstart coloring invalid: "
          f"{q['check']}")
    print(f"  11a torch_quickstart: {q['check']['n_colors']} colors after "
          f"{q['result']['n_iters_run']} iterations (initial "
          f"{q['result']['color']['n_colors_distinct']}), valid; "
          f"{time.perf_counter() - t:.3f} s", flush=True)
    t = time.perf_counter()
    with redirect_stdout(quiet):
        c = load_example("torch_coloring_sched").main(device=dev)
    print(f"  11a torch_coloring_sched: {c['single'][1]} groups for "
          f"{len(c['rows'])} samples; schedule_many "
          f"{[ng for _, ng, _ in c['many']]} groups, every schedule "
          f"conflict-free; {time.perf_counter() - t:.3f} s", flush=True)
    t = time.perf_counter()
    with redirect_stdout(quiet):
        d = load_example("torch_distributed_coloring").main(device=dev)
    g = core.rmat.rmat_er(14, 8, seed=1)
    check("sharded" in d, "11a the distributed example saw no world")
    valid = {name: core.check_coloring(g, d[name][0])
             for name in ("speed", "quality", "sharded")}
    for name, st in valid.items():
        check(st["valid"], f"11a distributed example, {name}: {st}")
    print(f"  11a torch_distributed_coloring: colors "
          f"{ {k: v['n_colors'] for k, v in valid.items()} } (sharded: "
          f"color_graph_sharded on the one-rank world), all valid; "
          f"{time.perf_counter() - t:.3f} s", flush=True)


def tools_projection(core, dev, mem: dict) -> None:
    """11(b): the projection of one path's partition against the tensors
    ``to_device`` makes of it and the path's measured peak."""
    from repro_torch import roofline
    pg = mem["pg"]
    sparse = mem["scheme"] == core.SPARSE
    proj = roofline.projection_of(pg, sparse=sparse)
    arrs = core.to_device(pg, dev, sparse=sparse)
    got = roofline.device_bytes(arrs)
    per = proj["per_shard_bytes"]
    check({k: per[k] for k in got} == got,
          f"11b {mem['label']}: projection {per} against to_device {got}")
    made = sum(t.numel() * t.element_size() for t in arrs.values())
    named = sum(got.values()) * pg.P
    check(named == made, f"11b {mem['label']}: the projection names "
          f"{named} of the {made} bytes to_device made")
    del arrs
    torch.cuda.empty_cache()
    total = proj["total_per_shard"] * pg.P
    print(f"  11b {mem['label']}: projection {total / 2**30:.3f} GiB "
          f"({proj['total_per_shard']} B per shard x {pg.P}: nbr "
          f"{per['nbr'] * pg.P / 2**30:.3f}, nbr2 "
          f"{per['nbr2'] * pg.P / 2**30:.3f}, CSR "
          f"{(per['indices'] + per['edge_src']) * pg.P / 2**30:.3f}, views "
          f"{per['views'] * pg.P / 2**30:.3f} GiB; {proj['hbm_fraction']:.5f}"
          f" of one shard's H100); to_device made {made / 2**30:.3f} GiB, "
          f"every named array equal; measured peak "
          f"{mem['peak'] / 2**30:.3f} GiB ({total / mem['peak']:.3f} of it "
          f"projected)", flush=True)


def tools_audit(core, run10a) -> None:
    """11(c): the recorder around 10(a)'s ``pipeline_sharded``."""
    from repro_torch.analysis import collective_audit as CA
    pg, order, cfg, mesh = run10a
    with CA.CollectiveRecorder() as rec:
        core.pipeline_sharded(pg, order, cfg, mesh)
    counts = rec.counts()
    check(CA.sequence_failures({0: rec.calls}) == [],
          "11c the one rank's sequence fails the audit")
    check(counts == MESH_COLLECTIVES,
          f"11c collectives {counts}, want {MESH_COLLECTIVES}")
    print(f"  11c collective audit of pipeline_sharded rmat_good("
          f"{MAIN_SCALE}) P={MESH_P}: {CA.count_line(rec.calls)} (PERF.md "
          f"§5: 51 all_reduce, 1 all_gather)", flush=True)


def tools_dryrun() -> None:
    """11(d): the coloring dry-run record of the production cell."""
    from repro_torch.launch import dryrun
    rec = dryrun.coloring_record(DRYRUN_SCALE, DRYRUN_P)
    check(rec["graph"]["P"] == DRYRUN_P and rec["sparse"]["n_rounds"] > 0,
          f"11d dry run: {rec['graph']}")
    print(f"  11d dry run --coloring rmat_er({DRYRUN_SCALE}, 8, seed=1) "
          f"P={DRYRUN_P}: {json.dumps(rec)}", flush=True)


def phase_tools(core, dev, run10a, mems) -> None:
    """Phase 11: the examples, the projection, the audit, the dry run."""
    t = time.perf_counter()
    tools_examples(core, dev)
    phase("11a examples", t)
    t0 = time.perf_counter()
    for mem in mems:
        tools_projection(core, dev, mem)
    phase("11b memory projection", t0)
    t0 = time.perf_counter()
    tools_audit(core, run10a)
    phase("11c collective audit", t0)
    t0 = time.perf_counter()
    tools_dryrun()
    phase("11d coloring dry run", t0)
    phase("11 the coloring system's last modules total", t)


# -- phase 12: the LM serving path ---------------------------------------------

def rel_err(got, want) -> float:
    """max |got - want| over max |want| (both moved to float32 on the CPU)."""
    got, want = got.float().cpu(), want.float().cpu()
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-30)


def lm_decode_equivalence(M, arch, params, inputs, first, plan) -> dict:
    """prefill(S) + one decode step against the full forward over S+1
    tokens (the prompt and the first generated token), the cache holding
    S+4 slots as in ``tests/test_models.py``.  Returns the relative error
    (``err``), each row's (``rows``), the rows whose argmax agrees
    (``agree``) and whether both logits are finite (``finite``).

    An MoE runs it with ample capacity (``capacity_factor`` 8, as that
    test does: with the config's own, the full forward drops tokens past
    an expert's capacity that the decode step keeps), and its routers'
    top-k picks in prefill and decode are pinned to the full forward's
    (``err``, ``rows``): a bf16 rounding that moves a near-tie changes a
    pick, a discrete change that the two paths' numerics do not bound.
    The picks that the paths made on their own and that differ are
    listed in ``flips`` (row, MoE layer, token, the full forward's margin
    between its k-th and (k+1)-th expert), with the error of that
    unpinned run (``free_err``, ``free_rows``)."""
    import repro_torch.models.moe as moe
    if arch.is_moe:
        arch = dataclasses.replace(arch, capacity_factor=8.0)
    S = inputs["tokens"].shape[1]
    toks = torch.cat([inputs["tokens"], first], dim=1)
    real, full, own, pin = moe.top_k, [], [], []

    def route(probs, k):
        vals, idx = real(probs, k)
        if len(full) < n_moe:                     # the full forward's
            full.append((probs.float(), idx))
            return vals, idx
        own.append(idx)
        if not pin:
            return vals, idx
        i = len(own) - 1
        layer, lo = i % n_moe, 0 if i < n_moe else S
        idx = full[layer][1][:, lo:lo + probs.shape[1]]
        return torch.gather(probs, -1, idx), idx

    def paths():
        cache, _ = M.prefill(params, inputs, arch, plan, cache_len=S + 4)
        _, got = M.decode_step(params, cache, first, arch, plan)
        return got.float().cpu()

    n_moe = sum(s.ffn == "moe" for s in M.layer_specs(arch))
    moe.top_k = route
    try:
        x, _, _ = M.backbone(params, toks, torch.arange(
            S + 1, device=toks.device)[None], arch, plan, mode="train")
        w = M._unembed(params, x[:, -1:], arch, plan).float().cpu()
        del x
        got = paths()
        if n_moe:
            picks, own[:] = own[:], []
            pin.append(True)
            free, got = got, paths()
    finally:
        moe.top_k = real
    scale = max(float(w.abs().max()), 1e-30)

    def rows(g):
        return [float((g[b] - w[b]).abs().max()) / scale
                for b in range(g.shape[0])]
    out = dict(rows=rows(got), agree=int((got.argmax(-1) == w.argmax(-1))
                                         .sum()),
               finite=bool(torch.isfinite(got).all()
                           and torch.isfinite(w).all()), flips=[])
    out["err"] = max(out["rows"])
    if n_moe:
        k = arch.n_experts_per_tok
        out["free_rows"] = rows(free)
        out["free_err"] = max(out["free_rows"])
        for layer, (pf, idx) in enumerate(full):
            mine = torch.cat([picks[layer], picks[n_moe + layer]], dim=1)
            top = torch.topk(pf, k + 1, dim=-1).values
            gap = top[..., k - 1] - top[..., k]
            same = (idx.sort(-1).values == mine.sort(-1).values).all(-1)
            out["flips"] += [(b, layer, t, float(gap[b, t]))
                             for b, t in (~same).nonzero().tolist()]
    return out


def lm_full(dev, name: str, label: str = "12", arch=None) -> int:
    """12(a)/(b) (16(a), 17(a): ``label``): one architecture at its
    published width and depth (``arch``: a cut of it), served."""
    from repro_torch.configs import get_arch, plan_for_mesh
    from repro_torch.launch import serve as S
    from repro_torch.launch.mesh import MeshSpec
    from repro_torch.models import init_params, model as M
    from repro_torch.models.layers import flatten
    arch = arch or get_arch(name)
    mesh = MeshSpec.local()
    plan = plan_for_mesh(mesh)
    torch.cuda.synchronize()
    t = time.perf_counter()
    params = init_params(M.param_defs(arch),
                         torch.Generator(device=dev).manual_seed(LM_SEED), dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t
    leaves = flatten(params).values()
    n = sum(p.numel() for p in leaves)
    w_bytes = sum(p.numel() * p.element_size() for p in leaves)
    check(n == arch.n_params(), f"{label} {name}: {n} parameters, the table says "
          f"{arch.n_params()}")
    torch.cuda.reset_peak_memory_stats()
    kw = dict(batch=LM_BATCH, prompt_len=LM_PROMPT, gen=LM_GEN, seed=LM_SEED,
              params=params, device=dev)
    runs = [S.serve(arch, mesh, plan, **kw) for _ in range(2)]  # cold, warm
    tokens = runs[1][0]
    check(torch.equal(runs[0][0], tokens), f"{label} {name}: the warm serve gave "
          "other tokens than the cold one")
    check(tokens.shape == (LM_BATCH, LM_GEN) and int(tokens.min()) >= 0
          and int(tokens.max()) < arch.vocab_padded(),
          f"{label} {name}: tokens {tuple(tokens.shape)} out of range")
    inputs = S.serve_inputs(arch, batch=LM_BATCH, prompt_len=LM_PROMPT,
                            seed=LM_SEED, device=dev)
    eq = lm_decode_equivalence(M, arch, params, inputs, tokens[:, :1], plan)
    err, agree, finite = eq["err"], eq["agree"], eq["finite"]
    peak = torch.cuda.max_memory_allocated()
    dt = lm_device_time(M, arch, plan, params, inputs, tokens)
    check(finite, f"{label} {name}: non-finite logits")
    if arch.is_moe:
        fl = eq["flips"]
        gaps = [f[3] for f in fl]
        print(f"  {label} {name} decode equivalence (capacity factor 8, "
              f"the routers' picks pinned to the full forward's) by row: "
              f"{' '.join(f'{x:.3e}' for x in eq['rows'])}; unpinned "
              f"{eq['free_err']:.4e}, by row "
              f"{' '.join(f'{x:.3e}' for x in eq['free_rows'])}; the "
              f"unpinned paths picked other top-{arch.n_experts_per_tok} "
              f"experts {len(fl)} times in rows "
              f"{sorted({f[0] for f in fl})} (MoE layers "
              f"{sorted({f[1] for f in fl})}), the full forward's margins "
              f"there {min(gaps, default=0):.3e}-{max(gaps, default=0):.3e}"
              f"; the last token's: "
              f"{[f for f in fl if f[2] == LM_PROMPT]}", flush=True)
    check(err <= LM_BF16_TOL, f"{label} {name}: prefill + decode against the "
          f"full forward {err:.3e} > {LM_BF16_TOL}")
    bound_ms = w_bytes / HBM_BYTES_PER_S * 1e3
    if arch.is_moe:
        print(f"  {label} {name}: the weight-bytes bound counts every "
              f"weight once, all {arch.n_experts} experts of each MoE layer "
              f"(top-{arch.n_experts_per_tok} of {LM_BATCH} rows can reach "
              f"all of them)", flush=True)
    for run, (_, st) in zip(("cold", "warm"), runs):
        step_ms = st["decode_s"] / (LM_GEN - 1) * 1e3
        print(f"  {label} {name} {run}: prefill {st['prefill_s']:.4f} s, decode "
              f"{st['decode_s']:.4f} s ({step_ms:.3f} ms per step, "
              f"{step_ms / bound_ms:.1f}x the weight-bytes bound "
              f"{bound_ms:.4f} ms), {st['tok_per_s']:.1f} tokens/s",
              flush=True)
    warm = runs[1][1]
    warm_step = warm["decode_s"] / (LM_GEN - 1)
    print(f"  {label} {name} device time (profiled): prefill {dt['prefill_s']:.4f}"
          f" s (idle {1 - dt['prefill_s'] / warm['prefill_s']:.3f} of the "
          f"warm prefill), decode {dt['step_s'] * 1e3:.3f} ms a step (idle "
          f"{1 - dt['step_s'] / warm_step:.3f} of the warm step), "
          f"{dt['step_kernels']:.0f} device kernels a step "
          f"({dt['step_kernels'] / arch.n_layers:.1f} a layer); per decode "
          f"step: {dt['top']}", flush=True)
    print(f"  {label} {name}: {arch.n_layers} of {get_arch(name).n_layers} "
          f"layers, d_model {arch.d_model}, "
          f"vocab {arch.vocab_size} (padded {arch.vocab_padded()}), {n:,} "
          f"parameters, {w_bytes / 1e9:.3f} GB bf16, drawn in {t_init:.3f} s; "
          f"batch {LM_BATCH}, prompt {LM_PROMPT}, gen {LM_GEN}; peak "
          f"{peak / 2**30:.3f} GiB; decode equivalence {err:.4e} of the "
          f"largest logit{' (routers pinned)' if arch.is_moe else ''} (tol "
          f"{LM_BF16_TOL}), argmax agrees on {agree}/"
          f"{LM_BATCH} rows, logits finite", flush=True)
    del params, runs
    gc.collect()
    torch.cuda.empty_cache()
    return peak


def lm_device_time(M, arch, plan, params, inputs, tokens) -> dict:
    """Device time (torch.profiler) of one warm prefill and of
    ``LM_PROFILED_STEPS`` decode steps fed the served ``tokens``; the top
    device consumers of the decode steps."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def busy(prof):
        ev = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
        return sum(e.self_device_time_total for e in ev) / 1e6, ev

    S = inputs["tokens"].shape[1]
    M.prefill(params, inputs, arch, plan, S)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        cache, _ = M.prefill(params, inputs, arch, plan, S)
        torch.cuda.synchronize()
    pre, _ = busy(prof)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(LM_PROFILED_STEPS):
            cache, _ = M.decode_step(params, cache, tokens[:, i:i + 1], arch,
                                     plan)
        torch.cuda.synchronize()
    dec, ev = busy(prof)
    top = sorted(ev, key=lambda e: -e.self_device_time_total)[:6]
    per = 1e3 * LM_PROFILED_STEPS
    return dict(prefill_s=pre, step_s=dec / LM_PROFILED_STEPS,
                step_kernels=sum(e.count for e in ev) / LM_PROFILED_STEPS,
                top="; ".join(f"{e.self_device_time_total / per:.3f} ms "
                              f"{e.key[:60]}" for e in top))


def lm_logits(M, arch, plan, params, inputs, tokens) -> list:
    """Prefill then decode fed ``tokens`` (teacher forcing): the logits of
    every step, on the CPU."""
    cache, logits = M.prefill(params, inputs, arch, plan,
                              inputs["tokens"].shape[1])
    out = [logits[:, -1].float().cpu()]
    for i in range(tokens.shape[1] - 1):
        cache, logits = M.decode_step(params, cache, tokens[:, i:i + 1],
                                      arch, plan)
        out.append(logits[:, -1].float().cpu())
    return out


def lm_smoke(dev, name: str) -> str:
    """12(c): one architecture at smoke size, float32, the same weights and
    prompts served on the card and on the CPU."""
    from repro_torch.configs import get_arch, plan_for_mesh, smoke_of
    from repro_torch.launch import serve as S
    from repro_torch.launch.mesh import MeshSpec
    from repro_torch.models import init_params, model as M
    from repro_torch.models.layers import tree_map
    arch = smoke_of(get_arch(name))
    plan = plan_for_mesh(MeshSpec.local())
    cpu = init_params(M.param_defs(arch),
                      torch.Generator().manual_seed(LM_SEED), "cpu")
    card = tree_map(lambda t: t.to(dev), cpu)
    got, _ = S.serve(arch, None, plan, seed=LM_SEED, params=card, device=dev,
                     **LM_SMOKE)
    want, _ = S.serve(arch, None, plan, seed=LM_SEED, params=cpu,
                      device="cpu", **LM_SMOKE)
    got = got.cpu()
    ins = {d: S.serve_inputs(arch, batch=LM_SMOKE["batch"],
                             prompt_len=LM_SMOKE["prompt_len"], seed=LM_SEED,
                             device=d) for d in ("cpu", dev)}
    lc = lm_logits(M, arch, plan, cpu, ins["cpu"], want)
    lg = lm_logits(M, arch, plan, card, ins[dev], want.to(dev))
    err = max(rel_err(g, c) for g, c in zip(lg, lc))
    check(err <= LM_F32_TOL, f"12c {name}: card against CPU logits "
          f"{err:.3e} > {LM_F32_TOL}")
    # tokens equal up to each row's first near-tie (top two within twice
    # the tolerance of the CPU's largest logit)
    compared = 0
    for b in range(want.shape[0]):
        upto = want.shape[1]
        for i, c in enumerate(lc):
            top = torch.topk(c[b].double(), 2).values
            if float(top[0] - top[1]) < 2 * LM_F32_TOL * float(c[b].abs().max()):
                upto = i + 1
                break
        check(torch.equal(got[b, :upto], want[b, :upto]),
              f"12c {name} row {b}: card tokens {got[b].tolist()} against "
              f"CPU {want[b].tolist()} before the first near-tie at {upto}")
        compared += upto
    return (f"{name} {err:.2e} ({compared}/{want.numel()} tokens before a "
            "near-tie)")


def phase_lm(dev) -> dict:
    """Phase 12: the LM serving path (``repro_torch.launch.serve``).
    Returns each full-width architecture's peak device bytes."""
    t = time.perf_counter()
    peaks = {}
    for i, name in enumerate(LM_FULL):
        t0 = time.perf_counter()
        peaks[name] = lm_full(dev, name)
        phase(f"12{'ab'[i]} {name} at full width and depth, bf16", t0)
    t0 = time.perf_counter()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        from repro_torch.configs import list_archs
        lines = [lm_smoke(dev, name) for name in list_archs()]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    print(f"  12c card against CPU, float32, serve batch "
          f"{LM_SMOKE['batch']} prompt {LM_SMOKE['prompt_len']} gen "
          f"{LM_SMOKE['gen']}, logits max relative error (tol {LM_F32_TOL}): "
          + "; ".join(lines), flush=True)
    phase("12c every architecture at smoke size, card against CPU", t0)
    phase("12 LM serving path total", t)
    return peaks


# -- phase 13: the LM training path --------------------------------------------

def train_timed(tr) -> list:
    """Time every step of ``tr`` (host clock between synchronises; the
    trainer reads its metrics back after each step at ``log_every=1``
    anyway).  Returns the list the times are appended to."""
    fn, times = tr._step_fn, []

    def timed(*args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        return out
    tr._step_fn = timed
    return times


def train_device_time(step_fn, params, opt, batch) -> dict:
    """Device time (torch.profiler) of one warm training step, and its top
    device consumers."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = step_fn(params, opt, batch)
        torch.cuda.synchronize()
    del out
    ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in ev) / 1e6
    top = sorted(ev, key=lambda e: -e.self_device_time_total)[:TRAIN_TOP]
    return dict(busy_s=busy, kernels=sum(e.count for e in ev),
                top="; ".join(f"{e.self_device_time_total / 1e3:.1f} ms "
                              f"x{e.count} {e.key[:56]}" for e in top))


def train_full(dev):
    """13(a): ``qwen3-0.6b`` at its published width and depth, trained
    through ``launch/train.py``'s ``Trainer`` with a failure at step 12;
    returns what 13(b) needs."""
    import shutil
    import tempfile
    from repro_torch.configs import ShapeConfig
    from repro_torch.data.pipeline import device_batch, host_batch
    from repro_torch.launch import train as T
    from repro_torch.roofline import model_flops
    with tempfile.TemporaryDirectory() as td:
        free = shutil.disk_usage(td).free
        tr = T.build([
            "--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS), "--batch",
            str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--ckpt-dir", td,
            "--ckpt-every", str(TRAIN_CKPT_EVERY), "--log-every", "1",
            "--fail-at", str(TRAIN_FAIL_AT), "--device", str(dev)])
        arch = tr.arch
        check(arch.params_dtype == arch.compute_dtype == "bfloat16"
              and arch.remat and tr.opt_cfg.state_dtype == "float32",
              f"13a {arch.name}: not bf16 params and compute, remat and "
              "float32 AdamW state")
        times = train_timed(tr)
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        params, opt = tr.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated()
        times = list(times)     # the run's steps (not the profiled one)
        batch = device_batch(host_batch(tr.data_cfg, TRAIN_STEPS, arch),
                             tr.mesh, tr.plan, dev)
        dt = train_device_time(tr._step_fn, params, opt, batch)
        del params, opt, batch
    gc.collect()
    torch.cuda.empty_cache()
    h = tr.history
    losses = [x["loss"] for x in h]
    steps = [x["step"] for x in h]
    check(tr.restarts == 1 and tr.injector.fired == [TRAIN_FAIL_AT],
          f"13a: restarts {tr.restarts}, fired {tr.injector.fired}")
    check(all(np.isfinite(losses)), f"13a: losses {losses}")
    check(losses[-1] < losses[0], f"13a: last loss {losses[-1]} not below "
          f"the first {losses[0]}")
    first = {s: x for s, x in zip(steps[:TRAIN_FAIL_AT],
                                  h[:TRAIN_FAIL_AT])}
    replay = h[TRAIN_FAIL_AT:TRAIN_FAIL_AT + TRAIN_FAIL_AT - TRAIN_CKPT_EVERY]
    check([x["step"] for x in replay] == list(range(
        TRAIN_CKPT_EVERY + 1, TRAIN_FAIL_AT + 1)),
        f"13a: steps {steps}")
    gap = max(abs(x["loss"] - first[x["step"]]["loss"])
              / abs(first[x["step"]]["loss"]) for x in replay)
    check(gap <= TRAIN_REPLAY_TOL, f"13a: replayed steps {gap:.3e} from "
          f"the first pass > {TRAIN_REPLAY_TOL}")
    shape = ShapeConfig("train", "train", TRAIN_SEQ, TRAIN_BATCH)
    flops = model_flops(arch, shape)
    cold = times[0]
    warm = statistics.median(times[1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    print(f"  13a {arch.name}: {arch.n_layers} layers, d_model "
          f"{arch.d_model}, {arch.n_heads}/{arch.n_kv_heads} heads of "
          f"{arch.head_dim_}, d_ff {arch.d_ff}, tied vocab "
          f"{arch.vocab_size} (padded {arch.vocab_padded()}), "
          f"{arch.n_params():,} parameters, bf16, remat, float32 AdamW; "
          f"batch {TRAIN_BATCH} x seq {TRAIN_SEQ}, {TRAIN_STEPS} steps, "
          f"checkpoint every {TRAIN_CKPT_EVERY}, failure at "
          f"{TRAIN_FAIL_AT}; {free / 2**30:.1f} GiB free in the checkpoint "
          "directory", flush=True)
    print(f"  13a steps: cold {cold:.4f} s, warm median {warm:.4f} s "
          f"({min(times[1:]):.4f}-{max(times[1:]):.4f} s over "
          f"{len(times) - 1}), {tokens / warm:.1f} tokens/s; model flops "
          f"{flops:.4e} a step, {flops / warm / 1e12:.1f} TFLOP/s = "
          f"{flops / warm / H100_BF16_PEAK:.4f} of the H100 SXM dense bf16 "
          f"peak ({H100_BF16_PEAK / 1e12:.1f} TFLOP/s); run {wall:.3f} s "
          f"for {len(times)} steps; peak {peak / 2**30:.3f} GiB",
          flush=True)
    print(f"  13a device time of a warm step (profiled): {dt['busy_s']:.4f}"
          f" s, idle {1 - dt['busy_s'] / warm:.3f} of the warm median, "
          f"{dt['kernels']} device kernels; top: {dt['top']}", flush=True)
    for rec in tr.ckpt_log:
        if rec["op"] == "save":
            print(f"  13a checkpoint save at step {rec['step']}: "
                  f"{rec['bytes'] / 1e9:.3f} GB, host snapshot "
                  f"{rec['snapshot_s']:.3f} s, background write "
                  f"{rec['write_s']:.3f} s", flush=True)
        else:
            print(f"  13a restore of step {rec['step']}: "
                  f"{rec['bytes'] / 1e9:.3f} GB in {rec['seconds']:.3f} s",
                  flush=True)
    print(f"  13a losses: {' '.join(f'{s}:{x:.4f}' for s, x in zip(steps, losses))}; "
          f"replayed steps {TRAIN_CKPT_EVERY + 1}-{TRAIN_FAIL_AT} within "
          f"{gap:.3e} of the first pass (tol {TRAIN_REPLAY_TOL})", flush=True)
    return tr, peak


def train_accum(dev, tr) -> None:
    """13(b): one step at ``grad_accum=2`` against ``grad_accum=1`` on
    13(a)'s first batch and initial state."""
    from repro_torch.data.pipeline import device_batch, host_batch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.layers import flatten
    params, opt = tr.init_state()
    batch = device_batch(host_batch(tr.data_cfg, 0, tr.arch), tr.mesh,
                         tr.plan, dev)
    out = {}
    for M in (1, 2):
        arch = dataclasses.replace(tr.arch, grad_accum=M)
        p, s, m = make_train_step(arch, tr.plan, tr.opt_cfg)(params, opt,
                                                             batch)
        out[M] = (flatten(p), flatten(s), float(m["loss"]))
        del p, s
    p0 = flatten(params)
    loss_err = abs(out[2][2] - out[1][2]) / abs(out[1][2])
    mv_err = max(float((out[2][1][k] - out[1][1][k]).abs().max())
                 / max(float(out[1][1][k].abs().max()), 1e-30)
                 for k in out[1][1] if k != "count")
    # bf16 parameters: each element within one bf16 rounding of the
    # grad_accum=1 result plus twice the step's largest move (a gradient
    # element near zero can turn Adam's first step around)
    move = max(float((out[1][0][k].float() - p0[k].float()).abs().max())
               for k in p0)
    eps = torch.finfo(torch.bfloat16).eps
    p_err, n_diff, n_all = 0.0, 0, 0
    for k in p0:
        a, b = out[1][0][k].float(), out[2][0][k].float()
        d = (b - a).abs()
        p_err = max(p_err, float((d / (eps * a.abs() + 2 * move)).max()))
        n_diff += int((d > 0).sum())
        n_all += d.numel()
    print(f"  13b grad_accum 2 against 1 on the first batch: loss "
          f"{out[2][2]:.6f} against {out[1][2]:.6f} ({loss_err:.3e}, tol "
          f"{TRAIN_ACCUM_TOL['loss']}); m and v {mv_err:.3e} of each leaf's "
          f"largest (tol {TRAIN_ACCUM_TOL['state']}); params: {n_diff} of "
          f"{n_all} elements differ, at most {p_err:.3f} of one bf16 "
          f"rounding plus twice the step's largest move {move:.3e} (tol "
          f"{TRAIN_ACCUM_TOL['params']})", flush=True)
    check(loss_err <= TRAIN_ACCUM_TOL["loss"], f"13b loss {loss_err:.3e}")
    check(mv_err <= TRAIN_ACCUM_TOL["state"], f"13b m/v {mv_err:.3e}")
    check(p_err <= TRAIN_ACCUM_TOL["params"], f"13b params {p_err:.3e}")
    del params, opt, out
    gc.collect()
    torch.cuda.empty_cache()


def train_smoke(dev, name: str) -> str:
    """13(c): one architecture at smoke size in float32: ``loss_fn``, its
    gradients and one AdamW step (from a carried nonzero state) on the
    card against the CPU on the same weights and batch."""
    from repro_torch.configs import NO_SHARDING, get_arch, smoke_of
    from repro_torch.data.pipeline import DataConfig, host_batch
    from repro_torch.models import init_params, loss_fn, model as M
    from repro_torch.models.layers import flatten, tree_map
    from repro_torch.train.optimizer import (OptConfig, adamw_update,
                                             value_and_grad)
    arch = smoke_of(get_arch(name))
    cpu = init_params(M.param_defs(arch),
                      torch.Generator().manual_seed(LM_SEED), "cpu")
    g = torch.Generator().manual_seed(LM_SEED + 1)
    state = {"m": tree_map(lambda t: torch.randn(t.shape, generator=g)
                           * 1e-3, cpu),
             "v": tree_map(lambda t: torch.randn(t.shape, generator=g).abs()
                           * 1e-5, cpu),
             "count": torch.tensor(3, dtype=torch.int32)}
    b = host_batch(DataConfig(arch.vocab_size, TRAIN_SMOKE_SEQ,
                              TRAIN_SMOKE_BATCH), 0, arch)
    opt = OptConfig(peak_lr=1e-3, warmup_steps=2, total_steps=50)
    res = {}
    for d in ("cpu", dev):
        to = lambda t, d=d: t.to(d)  # noqa: E731
        p, s = tree_map(to, cpu), tree_map(to, state)
        bb = {k: torch.from_numpy(v).to(d) for k, v in b.items()}
        loss, met, grads = value_and_grad(
            lambda q, x: loss_fn(q, x, arch, NO_SHARDING), p, bb)
        new_p, new_s, _ = adamw_update(p, grads, s, opt)
        res[str(d)] = (loss, met, flatten(grads), flatten(new_p),
                       flatten({"m": new_s["m"], "v": new_s["v"]}))
    c, k = res["cpu"], res[str(dev)]
    errs = dict(loss=max([rel_err(k[0], c[0])] + [
        rel_err(torch.as_tensor(k[1][m]), torch.as_tensor(c[1][m]))
        for m in c[1]]),
        grad=max(rel_err(k[2][n], c[2][n]) for n in c[2]),
        step=max(rel_err(k[3][n], c[3][n]) for n in c[3]),
        state=max(rel_err(k[4][n], c[4][n]) for n in c[4]))
    for what, tol in (("loss", TRAIN_F32_TOL["loss"]),
                      ("grad", TRAIN_F32_TOL["grad"]),
                      ("step", TRAIN_F32_TOL["step"]),
                      ("state", TRAIN_F32_TOL["grad"])):
        check(errs[what] <= tol, f"13c {name}: card against CPU {what} "
              f"{errs[what]:.3e} > {tol}")
    return (f"{name} loss {errs['loss']:.1e} grads {errs['grad']:.1e} "
            f"params {errs['step']:.1e} m/v {errs['state']:.1e}")


def phase_train(dev) -> int:
    """Phase 13: the LM training path (``repro_torch.launch.train``).
    Returns 13(a)'s peak device bytes."""
    t = time.perf_counter()
    tr, peak = train_full(dev)
    phase(f"13a {TRAIN_ARCH} trained at full width and depth, bf16", t)
    t0 = time.perf_counter()
    train_accum(dev, tr)
    phase("13b grad_accum 2 against 1", t0)
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        from repro_torch.configs import list_archs
        lines = [train_smoke(dev, name) for name in list_archs()]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    print(f"  13c card against CPU, float32, batch {TRAIN_SMOKE_BATCH} seq "
          f"{TRAIN_SMOKE_SEQ}, max relative errors (tol {TRAIN_F32_TOL}): "
          + "; ".join(lines), flush=True)
    phase("13c every architecture at smoke size, card against CPU", t0)
    phase("13 LM training path total", t)
    return peak

# -- phase 14: the LM on a mesh of ranks, and its dry run ----------------------

MESH_TRAIN_STEPS = 4
DRY_CELLS = tuple(("qwen3-0.6b", sh) for sh in (
    "train_4k", "prefill_32k", "decode_32k", "long_500k")) + (
    ("minicpm3-4b", "decode_32k"),)
DRY_LIMIT_S = 420.0       # a dry cell that runs longer is an error record
DRY_WORKERS = 5
# 14(c): the dry run's predicted peak against the peaks phases 12 and 13
# measured must lie within these factors
DRY_PEAK_RATIO = (0.5, 2.0)
# 14(b): the same cells' readings under the storage-only split, before
# the compute split (PERF.md section 6: peak GiB a rank, FLOP a rank,
# useful-flops ratio; what PERF.md did not record is None)
DRY_STORAGE_SPLIT = {
    ("qwen3-0.6b", "train_4k"): (40.644, 4.3953e14, 0.0333),
    ("qwen3-0.6b", "prefill_32k"): (9.433, None, None),
    ("qwen3-0.6b", "decode_32k"): (30.081, None, None),
    ("minicpm3-4b", "decode_32k"): (9.822, None, None)}
# 14(b): qwen3-0.6b train_4k with the split: at most this FLOP and peak
# GiB a rank, at least this useful-flops ratio
TP_DRY_LIMITS = dict(flops=5.5e13, peak_gib=20.3, useful=0.25)
# 14(b), 16(d): cells of DRY_CELLS and SSM_DRY_CELLS again with config
# fields replaced: the sequence-parallel residual (a peak a rank at least
# ``gib`` GiB below the cell's, no all-reduce of a (B, S, d) activation,
# FLOPs within ``flops`` of the cell's) and the once-a-step gather at
# grad_accum 4 (all-gather bytes no more than the cell's at grad_accum 1)
SP = (("seq_parallel_acts", True),)
DRY_VARIANTS = (("qwen3-0.6b", "train_4k", SP),
                ("qwen3-0.6b", "train_4k", (("grad_accum", 4),)))
SSM_DRY_VARIANTS = (("rwkv6-1.6b", "train_4k", SP),)
SP_DRY_LIMITS = {"qwen3-0.6b": dict(gib=1.6, flops=0.01),
                 "rwkv6-1.6b": dict(gib=2.8, flops=0.01)}


def dry_jobs() -> list:
    """14(b)'s production cells, then 14(c)'s one-rank cells on phase 13's
    and phase 12's own shapes."""
    jobs = [("cell", a, sh) for a, sh in DRY_CELLS]
    jobs += [("variant", a, sh, over) for a, sh, over in DRY_VARIANTS]
    jobs.append(("local", TRAIN_ARCH, "train", TRAIN_SEQ, TRAIN_BATCH))
    for name in LM_FULL:
        jobs.append(("local", name, "prefill", LM_PROMPT, LM_BATCH))
        jobs.append(("local", name, "decode", LM_PROMPT, LM_BATCH))
    return jobs


def dry_job(job) -> dict:
    """One dry-run job in a worker process (``meta`` tensors only)."""
    from repro_torch.configs import SHAPES, ShapeConfig, get_arch
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import MeshSpec
    t = time.perf_counter()
    if job[0] == "cell":
        out = Path(__file__).resolve().parent / "build" / "dryrun"
        rec = dryrun.dryrun_cell(job[1], job[2], multi_pod=False,
                                 out_dir=out, force=True,
                                 limit_s=job[3] if len(job) > 3
                                 else DRY_LIMIT_S)
    elif job[0] == "variant":
        _, name, sh, over = job[:4]
        rec = dryrun.lm_record(
            dataclasses.replace(get_arch(name), **dict(over)), SHAPES[sh],
            MeshSpec.production(), job[4] if len(job) > 4 else DRY_LIMIT_S)
        rec.update(arch=name, shape=sh, mesh="pod16x16", over=dict(over))
    else:
        _, name, kind, seq, batch = job
        rec = dryrun.lm_record(get_arch(name),
                               ShapeConfig(kind, kind, seq, batch),
                               MeshSpec.local(), DRY_LIMIT_S)
    rec["job"] = list(job)
    rec["wall_s"] = time.perf_counter() - t
    rec["cuda_initialized"] = torch.cuda.is_initialized()
    return rec


def start_dry():
    """The dry-run jobs in ``DRY_WORKERS`` background processes (CPU only;
    they run while the card works through phases 12-17(c)): (the pool,
    16(d)'s and 17(d)'s cells, 14(b, c)'s jobs).  The longest jobs go
    first (``qwen3-0.6b`` ``prefill_32k``, then jamba's ``train_4k``), so
    that the pool ends about when the card's phases do."""
    import multiprocessing
    pool = multiprocessing.get_context("spawn").Pool(DRY_WORKERS)
    jobs = pool.map_async(dry_job, dry_jobs(), chunksize=1)
    first = [c for c in SSM_DRY_CELLS if c in SCAN_DRY_CELLS]
    ssm = pool.map_async(dry_job, [("cell", a, sh, SSM_DRY_LIMIT_S) for a, sh
                                   in first + [c for c in SSM_DRY_CELLS
                                               if c not in first]]
                         + [("variant", a, sh, over, SSM_DRY_LIMIT_S)
                            for a, sh, over in SSM_DRY_VARIANTS], chunksize=1)
    return pool, ssm, jobs


def mesh_train(dev, M) -> None:
    """14(a): ``qwen3-0.6b`` at full width on a one-rank NCCL world
    (``MeshSpec.local().build()``): the sharded ``make_train_step`` (shards
    of a ``(1, 1)`` mesh, the layer gathers and gradient reductions over
    one rank) against the unsharded step on the same weights and batches,
    bitwise; then a sharded checkpoint save and restore, bitwise."""
    import tempfile
    from repro_torch.configs import get_arch, plan_for_mesh
    from repro_torch.data.pipeline import DataConfig, device_batch, host_batch
    from repro_torch.parallel.shard import CollectiveLog, RankMesh, set_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import param_defs
    from repro_torch.models.layers import flatten, specs_of
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.trainer import init_params_sharded
    mesh = M.MeshSpec.local().build()
    rm = RankMesh.of(mesh)
    arch = get_arch(TRAIN_ARCH)
    plan = plan_for_mesh(mesh)
    pdefs = param_defs(arch)
    specs = specs_of(pdefs, plan)
    opt_cfg = OptConfig(peak_lr=1e-3, warmup_steps=2,
                        total_steps=MESH_TRAIN_STEPS)
    dc = DataConfig(arch.vocab_size, TRAIN_SEQ, TRAIN_BATCH)
    step = make_train_step(arch, plan, opt_cfg)
    coll = {}

    def run(sharded: bool):
        where = mesh if sharded else M.MeshSpec.local()
        p = init_params_sharded(pdefs, where, specs, LM_SEED, dev)
        s = init_opt_state(p, opt_cfg)
        losses, times = [], []
        for i in range(MESH_TRAIN_STEPS):
            b = device_batch(host_batch(dc, i, arch),
                             mesh if sharded else None, plan, dev,
                             arch.grad_accum)
            rm.log = CollectiveLog() if sharded and i == 0 else None
            torch.cuda.synchronize()
            t = time.perf_counter()
            with set_mesh(rm if sharded else None):
                p, s, m = step(p, s, b)
            losses.append(float(m["loss"]))
            times.append(time.perf_counter() - t)
            if rm.log is not None:
                coll.update(count=dict(rm.log.count), bytes=dict(rm.log.bytes))
        rm.log = None
        return losses, p, s, times

    plain = run(False)
    got = run(True)
    check(got[0] == plain[0], f"14a losses {got[0]} against unsharded "
          f"{plain[0]}")
    for what, a, b in (("params", got[1], plain[1]),
                       ("m", got[2]["m"], plain[2]["m"]),
                       ("v", got[2]["v"], plain[2]["v"])):
        fa, fb = flatten(a), flatten(b)
        for k in fb:
            check(fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k]),
                  f"14a {what}/{k}: sharded step not bitwise the unsharded")
    plain_t = plain[3]
    del plain
    gc.collect()
    torch.cuda.empty_cache()
    state = {"params": got[1], "opt": got[2]}
    all_specs = {"params": specs, "opt": {"m": specs, "v": specs}}
    with tempfile.TemporaryDirectory() as td:
        t = time.perf_counter()
        ckpt.save(td, MESH_TRAIN_STEPS, state, mesh=mesh, specs=all_specs)
        t_save = time.perf_counter() - t
        t = time.perf_counter()
        step_r, back = ckpt.restore(td, mesh=mesh, specs=all_specs)
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t
    fa, fb = flatten(back), flatten(state)
    check(step_r == MESH_TRAIN_STEPS and fa.keys() == fb.keys(),
          f"14a restore: step {step_r}, keys {sorted(fa)[:4]}")
    for k in fb:
        check(fa[k].dtype == fb[k].dtype and fa[k].device == fb[k].device
              and torch.equal(fa[k], fb[k]), f"14a restore {k} not bitwise")
    print(f"  14a {arch.name} on a one-rank NCCL world {mesh.mesh_dim_names}"
          f" {tuple(mesh.mesh.shape)}: batch {TRAIN_BATCH} x seq "
          f"{TRAIN_SEQ}, bf16, remat; {MESH_TRAIN_STEPS} sharded steps "
          f"bitwise the unsharded (losses {' '.join(f'{x:.4f}' for x in got[0])}"
          f"; params, m, v equal); step seconds sharded "
          f"{' '.join(f'{x:.3f}' for x in got[3])}, unsharded "
          f"{' '.join(f'{x:.3f}' for x in plain_t)}; one "
          f"sharded step's collectives {coll['count']} bytes "
          f"{coll['bytes']}; checkpoint {ckpt.nbytes(state) / 1e9:.3f} GB "
          f"saved in {t_save:.3f} s, restored bitwise in {t_restore:.3f} s",
          flush=True)
    del state, back, got
    gc.collect()
    torch.cuda.empty_cache()


def phase_dry(pool, pending, early, peak12: dict, peak13: int) -> list:
    """14(b), (c): the dry-run records from the background processes;
    returns 16(d)'s (``early``)."""
    t0 = time.perf_counter()
    recs, ssm = pending.get(), early.get()
    pool.close()
    pool.join()
    waited = time.perf_counter() - t0
    check(not any(r["cuda_initialized"] for r in recs + ssm),
          "14b: a dry-run job initialised CUDA")
    cells = [r for r in recs if r["job"][0] == "cell"]
    for r in cells:
        check(r["status"] in ("ok", "skipped"),
              f"14b {r['job']}: {r.get('error', r['status'])}")
        line = f"  14b {r['arch']} {r['shape']} {r['mesh']}: {r['status']}"
        if r["status"] == "ok":
            ma, rf = r["memory_analysis"], r["roofline"]
            if (r["arch"], r["shape"]) == ("qwen3-0.6b", "train_4k"):
                lim = TP_DRY_LIMITS
                check(rf["flops"] <= lim["flops"]
                      and ma["total_per_device"] / 2**30 <= lim["peak_gib"]
                      and r["useful_flops_ratio"] >= lim["useful"],
                      f"14b {r['arch']} {r['shape']}: {rf['flops']:.4e} "
                      f"FLOP, {ma['total_per_device'] / 2**30:.3f} GiB, "
                      f"useful {r['useful_flops_ratio']:.4f} against "
                      f"{lim}")
            line += dry_cell_line(r, DRY_STORAGE_SPLIT.get(
                (r["arch"], r["shape"]), (None,) * 3))
        elif r["status"] == "skipped":
            line += f" ({r['reason']})"
        else:
            line += f" after {r['seconds']:.1f} s: {r['error'][:160]}"
        print(line, flush=True)
    for r in (r for r in recs if r["job"][0] == "variant"):
        print(f"  14b{dry_variant_line(r, cells, '14b')}", flush=True)
    local = {tuple(r["job"][1:3]): r for r in recs if r["job"][0] == "local"}
    for r in local.values():
        check(r["status"] == "ok", f"14c {r['job']}: {r.get('error')}")
    pred13 = local[TRAIN_ARCH, "train"]["memory_analysis"]["total_per_device"]
    rows = [(f"13a {TRAIN_ARCH} train {TRAIN_BATCH} x {TRAIN_SEQ}", pred13,
             peak13, local[TRAIN_ARCH, "train"]["seconds"])]
    for name in LM_FULL:
        pre = local[name, "prefill"]["memory_analysis"]["total_per_device"]
        dec = local[name, "decode"]["memory_analysis"]["total_per_device"]
        rows.append((f"12 {name} prefill {LM_BATCH} x {LM_PROMPT} + decode "
                     f"(cache {LM_PROMPT})", max(pre, dec), peak12[name],
                     local[name, "prefill"]["seconds"]
                     + local[name, "decode"]["seconds"]))
    for what, pred, meas, sec in rows:
        ratio = pred / meas
        print(f"  14c {what}: dry run at mesh (1, 1) predicts "
              f"{pred / 2**30:.3f} GiB, measured peak {meas / 2**30:.3f} GiB,"
              f" ratio {ratio:.3f} (limits {DRY_PEAK_RATIO}); dry seconds "
              f"{sec:.1f}", flush=True)
        check(DRY_PEAK_RATIO[0] <= ratio <= DRY_PEAK_RATIO[1],
              f"14c {what}: predicted/measured {ratio:.3f}")
    print(f"  14 dry run: {len(recs) + len(ssm)} jobs in {DRY_WORKERS} "
          f"background processes from phase 12 on; waited {waited:.1f} s "
          f"for them after 16(a)", flush=True)
    return ssm

# -- phase 15: the compute split on a (1, 2) gloo world of host processes ------

TP_ARCH, TP_LAYERS = "qwen3-0.6b", 2
# 4 greedy tokens (8 before phase 17 came: each decode step of a split
# run gathers weights over gloo, the most of 15's and 16(b)'s seconds)
TP_BATCH, TP_SEQ, TP_GEN = 2, 256, 4
TP_THREADS = 4            # torch threads of each of the two ranks
# the CPU tests' tolerances for one train step and for serving
# (tests/test_torch_tp.py): the loss and the gradient norm relative to
# their own magnitude; every leaf's gradient (``m``: AdamW's first moment
# after one step from zero, (1 - b1) times the clipped gradient) and
# ``v`` each relative to the leaf's largest value; the prefill's logits
# relative to the largest logit; greedy tokens equal up to each row's
# first near-tie (top-two margin below ``tie`` of the logits' scale).
# The stepped parameters are printed, not held: after one step from a
# zero AdamW state every element moves by about the learning rate in the
# sign of its gradient, so an element whose gradient is at rounding level
# may move either way in the two runs.
TP_TOL = dict(loss=3e-7, norm=6.3e-7, m=3e-6, v=3.3e-5, logits=1.6e-6,
              tie=2e-5)
# the layers each architecture keeps in the split runs of phases 15 and
# 16(b): qwen3-0.6b's first two; rwkv6-1.6b's first (its first two before
# phase 17 came); jamba-v0.1-52b's first (a Mamba mixer and its dense
# SwiGLU)
SPLIT_LAYERS = {"qwen3-0.6b": TP_LAYERS, "rwkv6-1.6b": 1,
                "jamba-v0.1-52b": 1}
# and the sequence length of their batch and prompt (16(b) at a quarter of
# phase 15's: its two runs took 63 s and 150 s at 256, 69 s and 147 s at
# 128 on the chip machine's host)
SPLIT_SEQ = {"qwen3-0.6b": TP_SEQ, "rwkv6-1.6b": 64, "jamba-v0.1-52b": 64}


def tp_arch(name: str = TP_ARCH, **over):
    """``name`` at its published widths cut to ``SPLIT_LAYERS`` layers,
    float32, one microbatch (``over``: more fields replaced)."""
    from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch(name), n_layers=SPLIT_LAYERS[name],
                               params_dtype="float32",
                               compute_dtype="float32", grad_accum=1, **over)


def tp_run(mesh, name: str = TP_ARCH, over: dict | None = None):
    """The split runs' work on ``mesh`` (a built ``DeviceMesh``, or
    ``None``: one process): one train step from the seeded weights, then
    serving (with ``over``, config fields replaced for the train step,
    the step alone).  Returns a dict: ``params0`` (the weights, this
    rank's shards), ``loss``, ``norm``, the stepped ``params``, ``m`` and
    ``v``, the prefill's ``logits`` of this rank's rows and the ``tokens``
    (whole; not with ``over``), and the ``seconds`` of the whole, of the
    weights' draw (``init_s``), the step (``step_s``) and serving
    (``serve_s``)."""
    from repro_torch.configs import plan_for_mesh
    from repro_torch.data.pipeline import (DataConfig, batch_spec,
                                           device_batch, host_batch)
    from repro_torch.launch.mesh import MeshSpec
    from repro_torch.launch.serve import (init_params_placed, serve,
                                          serve_inputs)
    from repro_torch.launch.steps import make_prefill_step, make_train_step
    from repro_torch.parallel.shard import as_rank_mesh, batch_rows, set_mesh
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    t = time.perf_counter()
    arch, seq = tp_arch(name, **(over or {})), SPLIT_SEQ[name]
    plan = plan_for_mesh(mesh if mesh is not None else MeshSpec.local())
    rm = as_rank_mesh(mesh)
    params = init_params_placed(arch, plan, LM_SEED, mesh, "cpu")
    opt_cfg = OptConfig(peak_lr=1e-3, warmup_steps=2)
    hb = host_batch(DataConfig(arch.vocab_size, seq, TP_BATCH), 0, arch)
    t_init = time.perf_counter()
    with set_mesh(rm):
        p, st, met = make_train_step(arch, plan, opt_cfg)(
            params, init_opt_state(params, opt_cfg),
            device_batch(hb, mesh, plan, "cpu", arch.grad_accum))
    t_step = time.perf_counter()
    out = dict(params0=params, loss=float(met["loss"]),
               norm=float(met["grad_norm"]), params=p, m=st["m"], v=st["v"],
               init_s=t_init - t, step_s=t_step - t_init)
    if over:
        return {**out, "seconds": time.perf_counter() - t}
    tokens, _ = serve(arch, mesh if mesh is not None else MeshSpec.local(),
                      plan, batch=TP_BATCH, prompt_len=seq, gen=TP_GEN,
                      seed=LM_SEED, params=params, device="cpu")
    inp = {k: batch_rows(v, batch_spec(k, v.shape, plan), rm)
           for k, v in serve_inputs(arch, batch=TP_BATCH, prompt_len=seq,
                                    seed=LM_SEED, device="cpu").items()}
    with set_mesh(rm):
        _, logits = make_prefill_step(arch, plan, seq)(params, inp)
    return {**out, "logits": logits, "tokens": tokens,
            "serve_s": time.perf_counter() - t_step,
            "seconds": time.perf_counter() - t}


def tp_margins(params, name: str = TP_ARCH) -> np.ndarray:
    """(batch, gen) top-two logit margins over the logits' scale of the
    one-process greedy run on the whole ``params`` (its own tokens fed
    back)."""
    from repro_torch.configs import NO_SHARDING
    from repro_torch.launch.serve import serve_inputs
    from repro_torch.models import decode_step, prefill
    arch, seq = tp_arch(name), SPLIT_SEQ[name]
    inp = serve_inputs(arch, batch=TP_BATCH, prompt_len=seq, seed=LM_SEED,
                       device="cpu")
    with torch.no_grad():
        cache, logits = prefill(params, inp, arch, NO_SHARDING, seq)
        out = []
        for _ in range(TP_GEN):
            lg = logits[:, -1].double()
            top = torch.topk(lg, 2, dim=-1).values
            out.append(((top[:, 0] - top[:, 1]) / lg.abs().amax(-1)).numpy())
            tok = lg.argmax(-1).to(torch.int32)[:, None]
            cache, logits = decode_step(params, cache, tok, arch, NO_SHARDING)
    return np.stack(out, axis=1)


def tp_rank_job(rank: int, store: str, plain_path: str, name: str, parts,
                variants, out_q) -> None:
    """One rank of a split world: the split run of ``name``, then each
    leaf's largest gap to the one-process run (``plain_path``) on this
    rank's shard, beside the whole leaf's largest value, for the trees of
    ``parts``; then, for each config override of ``variants``, its train
    step alone and the same gaps (the one-process run has no mesh, so the
    overrides of a mesh's layout leave it as it is)."""
    import torch.distributed as dist
    torch.set_num_threads(TP_THREADS)
    from repro_torch.launch.mesh import MeshSpec, init_world
    from repro_torch.models import param_defs
    from repro_torch.models.layers import flatten, specs_of
    from repro_torch.configs import plan_for_mesh
    from repro_torch.parallel.shard import RankMesh, shard_of
    try:
        init_world("gloo", f"file://{store}", rank=rank, world_size=2,
                   timeout_s=600)
        mesh = MeshSpec((1, 2), ("data", "model")).build("cpu")
        want = torch.load(plain_path, mmap=True)
        rm = RankMesh.of(mesh)
        specs = flatten(specs_of(param_defs(tp_arch(name)),
                                 plan_for_mesh(mesh)))

        def gaps_of(got) -> dict:
            gaps = {}
            for part in parts:
                mine, whole = flatten(got[part]), flatten(want[part])
                gaps[part] = {k: (float((mine[k] - shard_of(
                    whole[k], specs[k], rm)).abs().max()),
                    float(whole[k].abs().max())) for k in whole}
            return gaps
        got = tp_run(mesh, name)
        gaps = gaps_of(got)
        lg = got["logits"][:, -1].double()
        ref = want["logits"][:, -1].double()
        gaps["logits"] = {"last": (float((lg - ref).abs().max()),
                                   float(ref.abs().max()))}
        times = {k: got[k] for k in ("seconds", "init_s", "step_s",
                                     "serve_s")}
        out = dict(loss=got["loss"], norm=got["norm"], gaps=gaps,
                   tokens=got["tokens"].numpy(), **times, variants=[])
        del got
        for over in variants:
            got = tp_run(mesh, name, over)
            out["variants"].append(dict(loss=got["loss"], norm=got["norm"],
                                        gaps=gaps_of(got),
                                        seconds=got["seconds"]))
            del got
        out_q.put((rank, out))
        dist.destroy_process_group()
    except Exception:
        import traceback
        out_q.put((rank, traceback.format_exc()))


def two_ranks(target, args: tuple, work: str) -> tuple[dict, float]:
    """``target(rank, store, *args, out_q)`` on two spawned host processes
    (a gloo world through a ``file://`` store under ``work``): each rank's
    result (a traceback string where it failed) and the world's
    seconds."""
    import multiprocessing
    import queue
    ctx = multiprocessing.get_context("spawn")
    out_q = ctx.Queue()
    procs = [ctx.Process(target=target,
                         args=(r, f"{work}/store", *args, out_q))
             for r in range(2)]
    t = time.perf_counter()
    for pr in procs:
        pr.start()
    res = {}
    try:
        for _ in procs:
            r, val = out_q.get(timeout=600)
            res[r] = val
    except queue.Empty:
        res["timeout"] = "a rank gave no result in 600 s"
    for pr in procs:
        pr.join(timeout=30)
        if pr.is_alive():
            pr.terminate()
            pr.join()
    return res, time.perf_counter() - t


def held_gaps(gaps: dict, got: dict, plain: dict) -> None:
    """Add one rank's relative gaps to the one-process run (loss, norm, and
    each leaf of each compared tree against its largest value) to
    ``gaps``."""
    for k in ("loss", "norm"):
        gaps.setdefault(k, []).append(abs(got[k] - plain[k]) / abs(plain[k]))
    for part, leaf in got["gaps"].items():
        for k, (d, scale) in leaf.items():
            gaps.setdefault(part, []).append(d / max(scale, 1e-30))


def within(gaps: dict, tol: dict, what: str) -> str:
    """The worst of each gap, checked against ``tol``; their line."""
    worst = {k: max(v) for k, v in gaps.items()}
    line = " ".join(f"{k} {v:.3e}" for k, v in worst.items())
    for k in worst.keys() & tol.keys():
        check(worst[k] <= tol[k], f"{what} {k}: gap {worst[k]:.3e} > "
              f"{tol[k]} (gaps {line})")
    return line


def split_world(name: str, tol: dict, parts, label: str,
                variants=()) -> str:
    """``name``'s split run on a ``(1, 2)`` gloo world of two host
    processes against the same run in one process, held within ``tol``
    (the trees of ``parts`` compared leaf by leaf), and the train step of
    each config override of ``variants`` in the same world against the
    same one-process step; the line of what was measured."""
    import shutil
    import tempfile
    root = Path(__file__).resolve().parent / "build"
    root.mkdir(exist_ok=True)
    work = tempfile.mkdtemp(prefix=f"split{label}-", dir=root)
    try:
        t = time.perf_counter()
        plain = tp_run(None, name)
        plain_path = f"{work}/plain.pt"
        torch.save({k: plain[k] for k in (*parts, "logits")}, plain_path)
        margin = tp_margins(plain["params0"], name)
        plain = {k: plain[k] for k in ("loss", "norm", "tokens", "seconds")}
        t_plain = time.perf_counter() - t
        res, t_world = two_ranks(tp_rank_job, (plain_path, name, parts,
                                               tuple(variants)), work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    errors = [v for v in res.values() if isinstance(v, str)]
    check(not errors and len(res) == 2, f"{label} {name}: {errors}")
    gaps, extra = {}, [{} for _ in variants]
    for r in (0, 1):
        got = res[r]
        held_gaps(gaps, got, plain)
        for g, v in zip(extra, got["variants"]):
            held_gaps(g, v, plain)
        want = plain["tokens"].numpy()
        for b in range(TP_BATCH):
            ties = np.flatnonzero(margin[b] < tol["tie"])
            upto = int(ties[0]) + 1 if ties.size else TP_GEN
            check(np.array_equal(got["tokens"][b, :upto], want[b, :upto]),
                  f"{label} {name} rank {r} row {b}: tokens "
                  f"{got['tokens'][b]} against one process {want[b]} "
                  f"(first near-tie at {upto - 1})")
    line = within(gaps, tol, f"{label} {name}")
    more = "".join(
        f"; the train step with {over} on the same world: loss "
        f"{res[0]['variants'][i]['loss']:.6f}, gaps "
        f"{within(extra[i], tol, f'{label} {name} {over}')}, rank runs "
        f"{res[0]['variants'][i]['seconds']:.1f}, "
        f"{res[1]['variants'][i]['seconds']:.1f} s"
        for i, over in enumerate(variants))
    arch = tp_arch(name)
    return (f"{name} at published widths (d {arch.d_model}, d_ff "
            f"{arch.d_ff}, vocabulary {arch.vocab_size}), {arch.n_layers} "
            f"layer(s), float32, batch {TP_BATCH} x {SPLIT_SEQ[name]}, gen "
            f"{TP_GEN}: "
            f"a (1, 2) gloo world of two host processes ({TP_THREADS} "
            f"threads each) against one process; loss {res[0]['loss']:.6f} "
            f"(one process {plain['loss']:.6f}); gaps {line} (limits {tol}; "
            f"params not held); tokens {plain['tokens'].tolist()}; seconds: "
            f"one process {t_plain:.1f} (its run {plain['seconds']:.1f}), "
            f"the world {t_world:.1f} (rank runs {res[0]['seconds']:.1f}, "
            f"{res[1]['seconds']:.1f}: weights {res[0]['init_s']:.1f}, "
            f"step {res[0]['step_s']:.1f}, serving {res[0]['serve_s']:.1f})"
            + more)


def phase_tp() -> None:
    """15: the split run on a ``(1, 2)`` gloo world against one process,
    and the same world's step with the sequence-parallel residual."""
    line = split_world(TP_ARCH, TP_TOL, ("params", "m", "v"), "15",
                       ({"seq_parallel_acts": True},))
    print(f"  15 {line}", flush=True)


# -- phase 16: the sub-quadratic models on a mesh --------------------------------

SSM_ARCH = "rwkv6-1.6b"
SSM_TRAIN_STEPS = 4     # a cold step and three warm ones; a fourth, profiled
# 16(b): the CPU tests' tolerances for each architecture
# (tests/test_torch_tp_ssm.py's TOL: its gradient, v and logits limits
# for m, v and logits; the loss and the norm as they are)
SSM_SPLIT_TOL = {
    "rwkv6-1.6b": dict(loss=3e-7, norm=2.9e-5, m=1.7e-5, logits=3.9e-6,
                       tie=2e-5),
    "jamba-v0.1-52b": dict(loss=1.2e-6, norm=5e-6, m=1.5e-5, logits=4e-6,
                           tie=2e-5)}
# the host memory 16(b) needs free: jamba's cut holds 3.3 GB of float32
# weights, about five times that in one process with its gradients and
# AdamW state, and half as much again in each of the two ranks
SSM_SPLIT_FREE_GIB = 40.0
# 16(c): batch-1 decode over a cache split over data on a (2, 1) world
# (4 greedy tokens: 8 before phase 17 came)
SEQ_ARCH, SEQ_PROMPT, SEQ_CACHE, SEQ_GEN = "qwen3-0.6b", 1024, 4096, 4
# the CPU tests' tolerances (tests/test_torch_seq_cache.py): logits
# relative to the largest logit; the cache after decode relative to each
# leaf's largest value (the first layer's bitwise, as after the prefill)
SEQ_TOL = dict(logits=1.6e-6, cache=3.1e-6, tie=2e-5)
# 16(d): the sub-quadratic dry cells on pod16x16; PR 24's readings of the
# same cells (peak GiB a rank, FLOP a rank, useful-flops ratio), taken
# from PR 24's tree on the chip machine's host (PERF.md section 6, PR 25)
SSM_DRY_CELLS = tuple(("rwkv6-1.6b", sh) for sh in (
    "prefill_32k", "train_4k", "decode_32k", "long_500k")) + tuple(
    ("jamba-v0.1-52b", sh) for sh in (
        "train_4k", "prefill_32k", "decode_32k", "long_500k"))
# 17(d): the cells of SSM_DRY_CELLS that Mamba's scan lets finish (past
# 600 s with the per-step loop, PRs 23-26)
SCAN_DRY_CELLS = (("jamba-v0.1-52b", "train_4k"),
                  ("jamba-v0.1-52b", "prefill_32k"))
SSM_DRY_PR24 = {
    ("rwkv6-1.6b", "prefill_32k"): (6.644, 1.7339e14, 0.0748),
    ("rwkv6-1.6b", "train_4k"): (28.461, 6.9794e14, 0.0558),
    ("rwkv6-1.6b", "decode_32k"): (0.228, 2.1223e10, 0.0746),
    ("rwkv6-1.6b", "long_500k"): (0.130, 2.6529e9, 0.0047),
    ("jamba-v0.1-52b", "decode_32k"): (5.053, 4.1232e11, 0.0294),
    ("jamba-v0.1-52b", "long_500k"): (8.933, 5.3554e10, 0.0018)}
# 16(d)'s cells share the host's cores with phases 12-16(a) and phase
# 14's cells: the longest (rwkv6-1.6b prefill_32k) took 368.7 s so before
# its chunk terms were batched, 49.6 s after (PERF.md section 6, PR 25)
SSM_DRY_LIMIT_S = 600.0
# 16(d)'s limits: rwkv6-1.6b train_4k at most 1/8 of PR 24's FLOP a rank
# and a useful-flops ratio of at least 0.25; jamba-v0.1-52b long_500k at
# most 2.2 GiB a rank
SSM_DRY_LIMITS = dict(flop_share=1 / 8, useful=0.25, long_gib=2.2)


def ssm_train(dev) -> int:
    """16(a), training: ``SSM_ARCH`` at its published width and depth
    (bf16, remat, float32 AdamW) through ``make_train_step``, a cold step
    and four warm ones at ``TRAIN_BATCH`` x ``TRAIN_SEQ`` (the last
    profiled); returns the peak device bytes."""
    from repro_torch.configs import ShapeConfig, get_arch, plan_for_mesh
    from repro_torch.data.pipeline import DataConfig, device_batch, host_batch
    from repro_torch.launch.mesh import MeshSpec
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import init_params, param_defs
    from repro_torch.roofline import model_flops
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    arch = get_arch(SSM_ARCH)
    check(arch.params_dtype == arch.compute_dtype == "bfloat16" and arch.remat
          and arch.grad_accum == 1, f"16a {SSM_ARCH}: not bf16 with remat")
    plan = plan_for_mesh(MeshSpec.local())
    opt_cfg = OptConfig(peak_lr=1e-3, warmup_steps=2,
                        total_steps=SSM_TRAIN_STEPS + 1,
                        state_dtype="float32")
    params = init_params(param_defs(arch),
                         torch.Generator(device=dev).manual_seed(LM_SEED), dev)
    opt = init_opt_state(params, opt_cfg)
    step = make_train_step(arch, plan, opt_cfg)
    dc = DataConfig(arch.vocab_size, TRAIN_SEQ, TRAIN_BATCH)
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for i in range(SSM_TRAIN_STEPS):
        batch = device_batch(host_batch(dc, i, arch), None, plan, dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, opt, met = step(params, opt, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        losses.append(float(met["loss"]))
    peak = torch.cuda.max_memory_allocated()
    batch = device_batch(host_batch(dc, SSM_TRAIN_STEPS, arch), None, plan,
                         dev)
    dt = train_device_time(step, params, opt, batch)
    del params, opt, batch
    gc.collect()
    torch.cuda.empty_cache()
    check(all(np.isfinite(losses)), f"16a {SSM_ARCH}: losses {losses}")
    flops = model_flops(arch, ShapeConfig("train", "train", TRAIN_SEQ,
                                          TRAIN_BATCH))
    warm = statistics.median(times[1:])
    print(f"  16a {SSM_ARCH} training: {arch.n_layers} layers, d_model "
          f"{arch.d_model}, d_ff {arch.d_ff}, vocab {arch.vocab_size}, "
          f"{arch.n_params():,} parameters, bf16, remat, float32 AdamW; "
          f"batch {TRAIN_BATCH} x seq {TRAIN_SEQ}; steps: cold "
          f"{times[0]:.4f} s, warm median {warm:.4f} s "
          f"({min(times[1:]):.4f}-{max(times[1:]):.4f} s over "
          f"{len(times) - 1} unprofiled), {TRAIN_BATCH * TRAIN_SEQ / warm:.1f}"
          f" tokens/s; model flops {flops:.4e} a step, "
          f"{flops / warm / 1e12:.1f} TFLOP/s = "
          f"{flops / warm / H100_BF16_PEAK:.4f} of the H100 SXM dense bf16 "
          f"peak; peak {peak / 2**30:.3f} GiB; losses "
          f"{' '.join(f'{x:.4f}' for x in losses)}", flush=True)
    print(f"  16a {SSM_ARCH} device time of a warm step (profiled): "
          f"{dt['busy_s']:.4f} s, idle {1 - dt['busy_s'] / warm:.3f} of the "
          f"warm median, {dt['kernels']} device kernels; top: {dt['top']}",
          flush=True)
    return peak


def seq_run(mesh, feed=None) -> dict:
    """16(c)'s work on ``mesh`` (a built ``DeviceMesh``, or ``None``: one
    process): ``SEQ_ARCH``'s cut (``tp_arch``) prefills a batch of one
    ``SEQ_PROMPT``-token prompt into a ``SEQ_CACHE``-slot cache, then
    decodes, fed ``feed`` (1, SEQ_GEN - 1) or its own greedy tokens.
    Returns the last logits of each step (``logits``, (SEQ_GEN, V)), the
    ``tokens`` (1, SEQ_GEN), and the cache, whole, after the prefill and
    after the last step (``prefill_cache``, ``cache``; each leaf a
    tensor), and the ``seconds``."""
    from repro_torch.configs import plan_for_mesh
    from repro_torch.launch.mesh import MeshSpec
    from repro_torch.launch.serve import init_params_placed, serve_inputs
    from repro_torch.models import cache_defs, decode_step, prefill
    from repro_torch.models.layers import specs_of, tree_map
    from repro_torch.parallel.shard import as_rank_mesh, set_mesh, unshard_tree
    t = time.perf_counter()
    arch = tp_arch(SEQ_ARCH)
    plan = plan_for_mesh(mesh if mesh is not None else MeshSpec.local())
    rm = as_rank_mesh(mesh)
    params = init_params_placed(arch, plan, LM_SEED, mesh, "cpu")
    prompt = serve_inputs(arch, batch=1, prompt_len=SEQ_PROMPT, seed=LM_SEED,
                          device="cpu")
    cspecs = specs_of(cache_defs(arch, 1, SEQ_CACHE), plan)

    def whole(cache):
        got = cache if rm is None else unshard_tree(cache, cspecs, rm)
        return tree_map(lambda x: x.clone(), got)
    kw = dict(global_batch=1, cache_len=SEQ_CACHE)
    with torch.no_grad(), set_mesh(rm):
        cache, lg = prefill(params, prompt, arch, plan, SEQ_CACHE, 1)
        first = whole(cache)
        logits = [lg[0, -1]]
        toks = [int(lg[0, -1].argmax())]
        for i in range(SEQ_GEN - 1):
            tok = toks[-1] if feed is None else int(feed[0, i])
            cache, lg = decode_step(params, cache, torch.tensor(
                [[tok]], dtype=torch.int32), arch, plan, **kw)
            logits.append(lg[0, -1])
            toks.append(int(lg[0, -1].argmax()))
    return dict(logits=torch.stack(logits), tokens=torch.tensor([toks]),
                prefill_cache=first, cache=whole(cache),
                seconds=time.perf_counter() - t)


def seq_rank_job(rank: int, store: str, plain_path: str, out_q) -> None:
    """One rank of 16(c)'s ``(2, 1)`` world, fed the one-process tokens:
    its gaps to the one-process run (``plain_path``), its tokens and this
    rank's filled slots after the prefill."""
    import torch.distributed as dist
    torch.set_num_threads(TP_THREADS)
    from repro_torch.launch.mesh import MeshSpec, init_world
    from repro_torch.models.layers import flatten
    try:
        init_world("gloo", f"file://{store}", rank=rank, world_size=2,
                   timeout_s=600)
        mesh = MeshSpec((2, 1), ("data", "model")).build("cpu")
        want = torch.load(plain_path)
        got = seq_run(mesh, want["tokens"][:, :-1])
        pre, bpre = flatten(got["prefill_cache"]), flatten(
            want["prefill_cache"])
        end, bend = flatten(got["cache"]), flatten(want["cache"])
        first = sorted(k for k in bend if k.endswith(("/k", "/v")))
        out = dict(
            prefill_bitwise=all(torch.equal(pre[k], bpre[k]) for k in bpre),
            first_layer_bitwise=all(torch.equal(end[k][0], bend[k][0])
                                    for k in first),
            cache=max(float((end[k].float() - bend[k].float()).abs().max())
                      / max(float(bend[k].float().abs().max()), 1e-30)
                      for k in bend),
            logits=max(float((a - b).abs().max()) / float(b.abs().max())
                       for a, b in zip(got["logits"], want["logits"])),
            tokens=got["tokens"].numpy(), seconds=got["seconds"],
            filled=min(max(SEQ_PROMPT - rank * SEQ_CACHE // 2, 0),
                       SEQ_CACHE // 2))
        out_q.put((rank, out))
        dist.destroy_process_group()
    except Exception:
        import traceback
        out_q.put((rank, traceback.format_exc()))


def seq_world() -> None:
    """16(c): batch-1 decode over a cache split over ``data`` on a
    ``(2, 1)`` gloo world against one process."""
    import shutil
    import tempfile
    root = Path(__file__).resolve().parent / "build"
    root.mkdir(exist_ok=True)
    work = tempfile.mkdtemp(prefix="seq16-", dir=root)
    try:
        t = time.perf_counter()
        threads = torch.get_num_threads()
        torch.set_num_threads(TP_THREADS)     # the ranks' (bitwise matmuls)
        try:
            plain = seq_run(None)
        finally:
            torch.set_num_threads(threads)
        t_plain = time.perf_counter() - t
        torch.save(plain, f"{work}/plain.pt")
        res, t_world = two_ranks(seq_rank_job, (f"{work}/plain.pt",), work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    errors = [v for v in res.values() if isinstance(v, str)]
    check(not errors and len(res) == 2, f"16c: {errors}")
    lg = plain["logits"].double()
    top = torch.topk(lg, 2, dim=-1).values
    ties = np.flatnonzero(((top[:, 0] - top[:, 1]) / lg.abs().amax(-1))
                          .numpy() < SEQ_TOL["tie"])
    upto = int(ties[0]) + 1 if ties.size else SEQ_GEN
    want = plain["tokens"].numpy()
    for r in (0, 1):
        got = res[r]
        check(got["prefill_bitwise"], f"16c rank {r}: the gathered prefill "
              "cache is not bitwise the one-process cache")
        check(got["first_layer_bitwise"], f"16c rank {r}: the first layer's "
              "cache after decode is not bitwise the one-process cache")
        check(np.array_equal(got["tokens"][:, :upto], want[:, :upto]),
              f"16c rank {r}: tokens {got['tokens']} against one process "
              f"{want} (first near-tie at {upto - 1})")
        for k in ("logits", "cache"):
            check(got[k] <= SEQ_TOL[k], f"16c rank {r} {k}: {got[k]:.3e} > "
                  f"{SEQ_TOL[k]}")
    arch = tp_arch(SEQ_ARCH)
    print(f"  16c {SEQ_ARCH} at published widths, {arch.n_layers} layers, "
          f"float32: batch 1, a {SEQ_PROMPT}-token prompt in a "
          f"{SEQ_CACHE}-slot cache, {SEQ_GEN} greedy tokens, on a (2, 1) "
          f"gloo world (the slots split over data: {SEQ_CACHE // 2} a rank; "
          f"filled after the prefill {res[0]['filled']} and "
          f"{res[1]['filled']}) against one process: the gathered cache "
          f"bitwise after the prefill and in the first layer after the "
          f"decode, the rest within {max(res[r]['cache'] for r in (0, 1)):.3e}"
          f" (tol {SEQ_TOL['cache']}); logits within "
          f"{max(res[r]['logits'] for r in (0, 1)):.3e} of the largest (tol "
          f"{SEQ_TOL['logits']}); tokens {want.tolist()} equal (up to "
          f"{upto}); seconds: one process {t_plain:.1f}, the world "
          f"{t_world:.1f} (rank runs {res[0]['seconds']:.1f}, "
          f"{res[1]['seconds']:.1f})", flush=True)


def host_free_gib() -> float:
    """The host's available memory (``MemAvailable``), GiB."""
    for line in Path("/proc/meminfo").read_text().splitlines():
        if line.startswith("MemAvailable:"):
            return int(line.split()[1]) / 2**20
    return float("nan")


def phase_ssm_split() -> None:
    """16(b): the SSM split of each sub-quadratic architecture on a
    ``(1, 2)`` gloo world against one process."""
    free = host_free_gib()
    print(f"  16b host memory available: {free:.1f} GiB (needs "
          f"{SSM_SPLIT_FREE_GIB})", flush=True)
    check(free >= SSM_SPLIT_FREE_GIB, f"16b: {free:.1f} GiB of host memory "
          f"available, {SSM_SPLIT_FREE_GIB} needed")
    for name, tol in SSM_SPLIT_TOL.items():
        t = time.perf_counter()
        line = split_world(name, tol, ("m",), "16b")
        print(f"  16b {line}", flush=True)
        phase(f"16b the SSM split of {name} on a (1, 2) gloo world", t)


def dry_cell_line(r: dict, was: tuple) -> str:
    """One dry cell's readings beside an earlier reading ``was`` (peak
    GiB, FLOP, useful-flops ratio; ``None`` where not recorded)."""
    ma, rf = r["memory_analysis"], r["roofline"]
    line = (f" in {r['seconds']:.1f} s; per rank "
            f"{ma['total_per_device'] / 2**30:.3f} GiB peak "
            f"(arguments {ma['argument_size_in_bytes'] / 2**30:.3f}"
            f" GiB, fits {ma['fits']}), {rf['flops']:.4e} FLOP, "
            f"collectives {r['coll_count']}; roofline {rf['bottleneck']}"
            f" (compute {rf['compute_s']:.4f} s, memory "
            f"{rf['memory_s']:.4f} s, collective "
            f"{rf['collective_s']:.4f} s); useful flops "
            f"{r['useful_flops_ratio']:.4f}; collective bytes "
            f"{r['coll_bytes']}, wire bytes {r['coll_wire_bytes']}")
    if "cache_seq_replicated" in r:
        line += f"; cache_seq_replicated {r['cache_seq_replicated']}"
    was = [("not recorded" if v is None else f"{v:g}") for v in was]
    return line + (f" [storage-only split: peak {was[0]} GiB, {was[1]} "
                   f"FLOP, useful flops {was[2]}]")


def dry_variant_line(r: dict, cells: list, label: str) -> str:
    """A variant cell (``DRY_VARIANTS``) held beside its cell in
    ``cells``: the sequence-parallel residual within ``SP_DRY_LIMITS``,
    the once-a-step gather's all-gather bytes no more than the cell's."""
    key, over = (r["arch"], r["shape"]), r["over"]
    check(r["status"] == "ok", f"{label} {key} {over}: "
          f"{r.get('error', r['status'])}")
    base = next(c for c in cells if (c["arch"], c["shape"]) == key)
    gib = [x["memory_analysis"]["total_per_device"] / 2**30 for x in (base, r)]
    flops = [x["roofline"]["flops"] for x in (base, r)]
    ag = [x["coll_bytes"].get("all-gather", 0) for x in (base, r)]
    ar = [x["coll_bytes"].get("all-reduce", 0) for x in (base, r)]
    wire = [sum(x["coll_wire_bytes"].values()) for x in (base, r)]
    line = (f" {key[0]} {key[1]} {r['mesh']} with {over}: in "
            f"{r['seconds']:.1f} s; peak {gib[1]:.3f} GiB a rank (the cell "
            f"{gib[0]:.3f}), {flops[1]:.4e} FLOP ({flops[0]:.4e}), "
            f"collectives {r['coll_count']} ({base['coll_count']}), output "
            f"bytes {r['coll_bytes']} ({base['coll_bytes']}), wire bytes "
            f"{sum(r['coll_wire_bytes'].values()):.6g} ({wire[0]:.6g}); "
            f"roofline collective {r['roofline']['collective_s']:.4f} s "
            f"({base['roofline']['collective_s']:.4f} s)")
    if "seq_parallel_acts" in over:
        from repro_torch.configs import SHAPES, get_arch
        lim = SP_DRY_LIMITS[key[0]]
        sh = SHAPES[key[1]]
        act = str((sh.global_batch // 16, sh.seq_len,
                   get_arch(key[0]).d_model))     # pod16x16: data 16
        n_act = r["coll_shapes"].get("all-reduce", {}).get(act, 0)
        check(gib[0] - gib[1] >= lim["gib"] and n_act == 0
              and abs(flops[1] / flops[0] - 1) <= lim["flops"],
              f"{label} {key} {over}: peak {gib[1]:.3f} against "
              f"{gib[0]:.3f} GiB, {n_act} all-reduces of {act}, FLOP "
              f"{flops[1]:.4e} against {flops[0]:.4e} ({lim})")
        line += (f"; all-reduces of {act}: {n_act} (the cell "
                 f"{base['coll_shapes'].get('all-reduce', {}).get(act, 0)}"
                 f"); all-reduce bytes {ar[1]} ({ar[0]}); limits {lim}")
    if "grad_accum" in over:
        check(ag[1] <= ag[0], f"{label} {key} {over}: all-gather bytes "
              f"{ag[1]} > {ag[0]} at grad_accum 1")
    return line


def phase_ssm_dry(recs: list) -> None:
    """16(d): the sub-quadratic dry cells with the split, each beside PR
    24's reading, against ``SSM_DRY_LIMITS``, and ``SSM_DRY_VARIANTS``
    beside their cells."""
    lim = SSM_DRY_LIMITS
    cells = [r for r in recs if r["job"][0] == "cell"]
    for r in cells:
        key = (r["arch"], r["shape"])
        label = "17d" if key in SCAN_DRY_CELLS else "16d"
        check(r["status"] == "ok", f"{label} {key}: "
              f"{r.get('error', r['status'])}")
        ma, rf = r["memory_analysis"], r["roofline"]
        check(ma["fits"], f"{label} {key}: {ma['total_per_device']} bytes a "
              "rank do not fit the card")
        gib = ma["total_per_device"] / 2**30
        was = SSM_DRY_PR24.get(key, (None,) * 3)
        if "cache_seq_replicated" in r:
            check(r["cache_seq_replicated"] is False,
                  f"16d {key}: the cache keeps a split sequence whole")
        if key == ("rwkv6-1.6b", "train_4k"):
            check(was[1] is not None
                  and rf["flops"] <= lim["flop_share"] * was[1]
                  and r["useful_flops_ratio"] >= lim["useful"],
                  f"16d {key}: {rf['flops']:.4e} FLOP against PR 24's "
                  f"{was[1]}, useful {r['useful_flops_ratio']:.4f} ({lim})")
        if key == ("jamba-v0.1-52b", "long_500k"):
            check(gib <= lim["long_gib"], f"16d {key}: {gib:.3f} GiB a rank "
                  f"> {lim['long_gib']}")
        print(f"  {label} {r['arch']} {r['shape']} {r['mesh']}: "
              f"{r['status']}" + dry_cell_line(r, was), flush=True)
    for r in (r for r in recs if r["job"][0] == "variant"):
        print(f"  16d{dry_variant_line(r, cells, '16d')}", flush=True)


# -- phase 17: Mamba's selective scan, jamba at its published widths ------------

SCAN_ARCH = "jamba-v0.1-52b"
# 17(a): served cut to one period of its interleave (Mamba at 0-3 and 5-7,
# attention at 4, MoE at the odd layers): the whole model's 96 GiB of bf16
# weights do not fit the card
SCAN_SERVE_LAYERS = 8
# 17(b): one Mamba layer at full width, float32, the scan against its plain
# version within the CPU test's float32 tolerances against the reference
# (tests/test_torch_mamba_scan.py's FWD_TOL, GRAD_TOL: y and h_S, and every
# input's gradient, relative to each one's largest value)
SCAN_BATCH, SCAN_SEQ = 8, 1024
SCAN_TOL = dict(fwd=1.2e-6, grad=3.3e-6)
# 17(c): trained cut to its first two layers (Mamba + SwiGLU, Mamba + MoE)
# with the config's own grad_accum (8) and bf16 AdamW state, remat; a
# cold step and two warm ones, then one profiled
SCAN_TRAIN_LAYERS, SCAN_TRAIN_STEPS = 2, 3


def jamba_cut(layers: int):
    from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch(SCAN_ARCH), n_layers=layers)


def scan_inputs(dev) -> list:
    """17(b)'s scan inputs: what ``mamba_apply`` hands ``mamba_scan`` in
    one Mamba layer at full width (seeded float32 weights, the zero-drawn
    ``log_a``, ``dt_bias`` and ``conv_b`` drawn as the CPU test draws them;
    a seeded input and state) on ``SCAN_BATCH`` x ``SCAN_SEQ``."""
    from repro_torch.configs import NO_SHARDING
    from repro_torch.models import init_params, ssm
    arch = jamba_cut(1)
    defs = {k: dataclasses.replace(d, init="normal", scale=0.5)
            if d.init == "zeros" else d
            for k, d in ssm.mamba_defs(arch, "float32").items()}
    gen = torch.Generator(device=dev).manual_seed(LM_SEED)
    p = init_params(defs, gen, dev)
    di = arch.expand * arch.d_model
    x = 0.5 * torch.randn((SCAN_BATCH, SCAN_SEQ, arch.d_model), generator=gen,
                          device=dev)
    conv = torch.zeros((SCAN_BATCH, arch.d_conv - 1, di), device=dev)
    h0 = torch.randn((SCAN_BATCH, di, arch.d_state), generator=gen,
                     device=dev)
    seen, real = [], ssm.mamba_scan

    def grab(*args):
        seen.extend(a.detach().clone() for a in args)
        return real(*args)
    ssm.mamba_scan = grab
    try:
        with torch.no_grad():
            ssm.mamba_apply(p, x, conv, h0, arch, NO_SHARDING)
    finally:
        ssm.mamba_scan = real
    return seen


def scan_vs_plain(dev) -> None:
    """17(b): ``mamba_scan`` against ``_mamba_scan_steps`` on one full-width
    layer's own inputs: y, h_S and the gradient of every input under seeded
    cotangents, each within ``SCAN_TOL`` of the plain version's largest
    value; the walls and peaks of each (a cold and a warm run)."""
    from repro_torch.models import ssm
    args = scan_inputs(dev)
    gen = torch.Generator(device=dev).manual_seed(LM_SEED + 1)
    gy = torch.randn(args[0].shape, generator=gen, device=dev)
    gh = torch.randn(args[5].shape, generator=gen, device=dev)

    def run(fn):
        walls = []
        for _ in range(2):                                # cold, warm
            ins = [a.clone().requires_grad_() for a in args]
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            torch.cuda.synchronize()
            t = time.perf_counter()
            y, h = fn(*ins)
            torch.cuda.synchronize()
            t_fwd = time.perf_counter() - t
            g = torch.autograd.grad((y * gy).sum() + (h * gh).sum(), ins)
            torch.cuda.synchronize()
            walls.append((t_fwd, time.perf_counter() - t))
            peak = torch.cuda.max_memory_allocated() - base
        return y.detach(), h.detach(), g, walls, peak

    got = run(ssm.mamba_scan)
    want = run(ssm._mamba_scan_steps)
    gaps = dict(y=rel_err(got[0], want[0]), h=rel_err(got[1], want[1]))
    for name, a, b in zip(("dt", "u", "B", "C", "A", "h0"), got[2], want[2]):
        gaps["d" + name] = rel_err(a, b)
    for k, v in gaps.items():
        tol = SCAN_TOL["grad" if k.startswith("d") else "fwd"]
        check(v <= tol, f"17b {k}: the scan against the plain steps {v:.3e} "
              f"> {tol}")
    B, S, di = args[0].shape
    ds = args[2].shape[-1]
    chunk = ssm.scan_chunk(B, S, di, ds)

    def walls(w):
        return (f"cold {w[0][0]:.4f} s forward, {w[0][1]:.4f} s with the "
                f"backward; warm {w[1][0]:.4f} s, {w[1][1]:.4f} s")
    print(f"  17b one Mamba layer of {SCAN_ARCH} at full width (di {di}, "
          f"d_state {ds}), float32, {B} x {S}: the scan (chunks of {chunk} "
          f"steps, {(S + chunk - 1) // chunk} chunks) against the plain steps"
          f", y {gaps['y']:.3e}, h_S {gaps['h']:.3e} (tol "
          f"{SCAN_TOL['fwd']}); gradients "
          + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items()
                      if k.startswith("d"))
          + f" (tol {SCAN_TOL['grad']}); scan {walls(got[3])}, peak "
          f"{got[4] / 2**30:.3f} GiB above its inputs; plain steps "
          f"{walls(want[3])}, peak {want[4] / 2**30:.3f} GiB", flush=True)
    del got, want, args
    gc.collect()
    torch.cuda.empty_cache()


def scan_train(dev) -> None:
    """17(c): jamba's published widths cut to ``SCAN_TRAIN_LAYERS`` layers
    through ``make_train_step`` at ``TRAIN_BATCH`` x ``TRAIN_SEQ`` with its
    own grad_accum and bf16 AdamW state, remat: a cold step and warm ones,
    then one profiled."""
    from repro_torch.configs import ShapeConfig, plan_for_mesh
    from repro_torch.data.pipeline import DataConfig, device_batch, host_batch
    from repro_torch.launch.mesh import MeshSpec
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import init_params, param_defs
    from repro_torch.roofline import model_flops
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    arch = jamba_cut(SCAN_TRAIN_LAYERS)
    check(arch.params_dtype == arch.compute_dtype == "bfloat16" and arch.remat
          and arch.grad_accum == 8 and arch.opt_state_dtype == "bfloat16",
          f"17c {SCAN_ARCH}: not bf16 with remat, grad_accum 8, bf16 state")
    plan = plan_for_mesh(MeshSpec.local())
    opt_cfg = OptConfig(peak_lr=1e-3, warmup_steps=2,
                        total_steps=SCAN_TRAIN_STEPS + 1,
                        state_dtype=arch.opt_state_dtype)
    torch.cuda.reset_peak_memory_stats()
    params = init_params(param_defs(arch),
                         torch.Generator(device=dev).manual_seed(LM_SEED), dev)
    opt = init_opt_state(params, opt_cfg)
    step = make_train_step(arch, plan, opt_cfg)
    dc = DataConfig(arch.vocab_size, TRAIN_SEQ, TRAIN_BATCH)
    times, losses = [], []
    for i in range(SCAN_TRAIN_STEPS):
        batch = device_batch(host_batch(dc, i, arch), None, plan, dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, opt, met = step(params, opt, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        losses.append(float(met["loss"]))
    peak = torch.cuda.max_memory_allocated()
    batch = device_batch(host_batch(dc, SCAN_TRAIN_STEPS, arch), None, plan,
                         dev)
    dt = train_device_time(step, params, opt, batch)
    del params, opt, batch
    gc.collect()
    torch.cuda.empty_cache()
    check(all(np.isfinite(losses)), f"17c {SCAN_ARCH}: losses {losses}")
    flops = model_flops(arch, ShapeConfig("train", "train", TRAIN_SEQ,
                                          TRAIN_BATCH))
    warm = statistics.median(times[1:])
    print(f"  17c {SCAN_ARCH} training: {arch.n_layers} of 32 layers "
          f"(Mamba + SwiGLU, Mamba + MoE), d_model {arch.d_model}, "
          f"{arch.n_params():,} parameters ({arch.n_active_params():,} "
          f"active), bf16, remat, grad_accum {arch.grad_accum}, bf16 AdamW "
          f"state; batch {TRAIN_BATCH} x seq {TRAIN_SEQ}; steps: cold "
          f"{times[0]:.4f} s, warm median {warm:.4f} s ("
          + " ".join(f"{x:.4f}" for x in times[1:])
          + f"), {TRAIN_BATCH * TRAIN_SEQ / warm:.1f} tokens/s; model flops "
          f"(6 N_active D) {flops:.4e} a step, {flops / warm / 1e12:.1f} "
          f"TFLOP/s = {flops / warm / H100_BF16_PEAK:.4f} of the H100 SXM "
          f"dense bf16 peak; peak {peak / 2**30:.3f} GiB; losses "
          f"{' '.join(f'{x:.4f}' for x in losses)}", flush=True)
    print(f"  17c {SCAN_ARCH} device time of a warm step (profiled): "
          f"{dt['busy_s']:.4f} s, idle {1 - dt['busy_s'] / warm:.3f} of the "
          f"warm median, {dt['kernels']} device kernels; top: {dt['top']}",
          flush=True)


def phase_scan(dev, peak12: dict) -> None:
    """17(a)-(c) on the card (17(d) runs in the dry-run pool)."""
    t = time.perf_counter()
    peak = lm_full(dev, SCAN_ARCH, "17a", jamba_cut(SCAN_SERVE_LAYERS))
    print(f"  17a peak {peak / 2**30:.3f} GiB against phase 12's "
          + ", ".join(f"{k} {v / 2**30:.3f} GiB" for k, v in peak12.items()),
          flush=True)
    phase(f"17a {SCAN_ARCH} served at published widths, "
          f"{SCAN_SERVE_LAYERS} layers, bf16", t)
    t = time.perf_counter()
    scan_vs_plain(dev)
    phase("17b the Mamba scan against its plain steps at full width", t)
    t = time.perf_counter()
    scan_train(dev)
    phase(f"17c {SCAN_ARCH} trained at published widths, "
          f"{SCAN_TRAIN_LAYERS} layers", t)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import repro_torch.core as core
    from repro_torch.kernels import build, ops

    dev = torch.device(DEVICE)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    t = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    logs = build.build()
    for name, log in logs.items():
        for line in log.splitlines():
            if any(w in line.lower() for w in ("registers", "smem",
                                                "spill")):
                print(f"  nvcc {name}: {line.strip()}")
    phase("1 card and build", t)

    t = time.perf_counter()
    measured = phase_kernels(ops, dev)
    measured.update(phase_kernels_d2(ops, dev))
    phase("2 kernels vs plain (bitwise)", t)

    t = time.perf_counter()
    launches, runs, main, mem3 = phase_main_path(core, ops, dev)
    measured.update(runs)
    phase(f"3 main path rmat_good({MAIN_SCALE}) P={MAIN_P} K={MAIN_K}", t)

    t = time.perf_counter()
    phase_cross_check(core, dev)
    phase(f"4 cross-check rmat_good({CROSS_SCALE}) P={CROSS_P} K={CROSS_K} "
          "kernels/plain x sparse/allgather", t)

    t = time.perf_counter()
    launches_d2, runs, mem5 = phase_d2_path(core, ops, dev)
    measured.update(runs)
    phase(f"5 distance-2 path grid3d{D2_GRID} halo=2 P={D2_P} K={D2_K}", t)
    print(f"  launches on the distance-1 path {launches}; on the distance-2 "
          f"path {launches_d2}")
    for name in ("color_select_d2", "conflict_d2", "select_run_d2",
                 "conflict_frontier_d2"):
        launches[name] = launches_d2[name]

    t = time.perf_counter()
    d2_cross = phase_d2_cross_check(core, dev)
    phase(f"6 distance-2 cross-check grid3d{D2_CROSS_GRID} P={D2_P} "
          f"K={D2_CROSS_K} kernels/plain x sparse/allgather, partial", t)

    t = time.perf_counter()
    launches_v, runs = phase_variants(core, ops, dev, main, d2_cross)
    measured.update(runs)
    launches.update(launches_v)
    phase(f"7 variant paths rmat_good({MAIN_SCALE}) P={MAIN_P} and "
          f"grid3d{D2_CROSS_GRID} P={D2_P}", t)

    t = time.perf_counter()
    goods = phase_many(core, ops, dev, d2_cross)
    phase(f"8 color_many: rmat({MANY_SCALE}) buckets P={MANY_P} and a D2 "
          "bucket", t)

    serve_graphs = phase_serve(core, ops, dev)

    with nccl_world(dev) as M:
        run10a = phase_mesh(core, ops, dev, M, main[0], goods, serve_graphs)
        phase_tools(core, dev, run10a, (mem3, mem5))
    gc.collect()
    torch.cuda.empty_cache()
    pool, early, pending = start_dry()
    peak12 = phase_lm(dev)
    gc.collect()
    torch.cuda.empty_cache()
    peak13 = phase_train(dev)
    gc.collect()
    torch.cuda.empty_cache()

    t = time.perf_counter()
    with nccl_world(dev) as M:
        mesh_train(dev, M)
    phase("14a sharded training on a one-rank NCCL world, bitwise", t)
    t = time.perf_counter()
    lm_full(dev, SSM_ARCH, "16a")
    ssm_train(dev)
    gc.collect()
    torch.cuda.empty_cache()
    phase(f"16a {SSM_ARCH} served and trained at full width and depth, "
          "bf16", t)
    phase_scan(dev, peak12)
    t = time.perf_counter()
    ssm_recs = phase_dry(pool, pending, early, peak12, peak13)
    phase("14bc dry-run cells and predicted peaks", t)
    t = time.perf_counter()
    phase_ssm_dry(ssm_recs)
    phase("16d, 17d the sub-quadratic dry cells with the split", t)
    t = time.perf_counter()
    phase_tp()
    phase(f"15 the compute split on a (1, 2) gloo world, {TP_ARCH} at "
          f"published widths", t)
    t = time.perf_counter()
    phase_ssm_split()
    phase("16b the SSM splits on (1, 2) gloo worlds", t)
    t = time.perf_counter()
    seq_world()
    phase("16c batch-1 decode over a sequence-split cache on a (2, 1) gloo "
          "world", t)

    kernels = []
    # launches: each kernel on its own path (the tile-form select and
    # conflict kernels serve ops.select_colors[_d2] and
    # ops.detect_conflicts[_d2] and are expected at 0 there)
    # (the sequential kernels replace the reference's _greedy_chunk loop,
    # which is no Pallas kernel; their launches are phase 7's; the push
    # exchange replaces no kernel, the reference's exchange being a plain
    # gather; its launches are phase 3's)
    firstfit, greedy = "src/repro/kernels/firstfit.py", (
        "src/repro/core/speculative.py:188")
    for name, where in (("color_select", f"{firstfit}:172"),
                        ("conflict", f"{firstfit}:240"),
                        ("color_select_d2", f"{firstfit}:205"),
                        ("conflict_d2", f"{firstfit}:258"),
                        ("select_run", f"{firstfit}:172"),
                        ("select_run_d2", f"{firstfit}:205"),
                        ("conflict_frontier", f"{firstfit}:240"),
                        ("conflict_frontier_d2", f"{firstfit}:258"),
                        ("greedy_run", greedy), ("greedy_run_d2", greedy),
                        ("exchange_push", None)):
        m = measured[name]
        src = f"src/repro_torch/kernels/csrc/{build.SOURCES[name]}"
        kernels.append(dict(name=name, route="cuda", source=src,
                            replaces=where,
                            launches=launches[name], max_abs_err=m["err"],
                            ms=m["ms"], plain_ms=m["plain_ms"],
                            bound_ms=m["bound"], bound_by=m["by"],
                            library_ms=None))
    print(f"  profiler traces taken again for lost device events: "
          f"{len(LOST_TRACES)} {LOST_TRACES}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
