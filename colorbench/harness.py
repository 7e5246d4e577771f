"""One run of one cell: set-up, the measured window, the check, the result.

Everything that belongs to one configuration, traffic mix or metric is a
file found by its name in the manifest (``BENCHMARK.json``):
``configs/<config>.json``, ``traffic/<traffic>.json`` and
``metrics/<metric>.py`` under the benchmark's folder.  A metric's file
defines ``read(run) -> float | None`` over the ``Run`` record below; a
reader that finds nothing to read returns None and the metric is left
out of the result.

Set-up (``setup_s``, from the start of the process): the graph made on the
device from the seed, its CSR brought to the host and handed to the
program, which partitions it and moves it to the device; then the
warm-up solves.  The window: solves back to back from one
caller (a closed loop), solve ``i`` with the key ``fold_in(key(seed),
i)``, until ``--seconds`` have passed; each solve ends in a synchronize
and the read of its color count.  With ``--trace 1`` the profiler records
the window, with a span around the window, each solve and each stage.
After the window: the peak device memory, the modules loaded, then the
program's state freed and the reference's judgement of the sampled solves
(``reference.judge``: every number against its limit).
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from colorbench import graphs, reference
from colorbench import trace as tracing
from colorbench.program import Program, key

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# top-level module names the run may not load: the JAX package and JAX
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# every number the reference gives is exact: no conflict, no vertex out of
# range, no vertex off the reference's recoloring
LIMITS = {"color.out_of_range": 0, "color.conflicts": 0,
          "final.out_of_range": 0, "final.conflicts": 0, "final.differ": 0}
# the warm-up: at least this many solves and this many seconds, so that
# the window finds every kernel built and the card at its clocks; their
# keys lie apart from the window's 0, 1, 2, ...
WARMUP_SOLVES = 3
WARMUP_SECONDS = 2.0
WARMUP_KEY = 2**32 - 1
# `colors` is the mean over the window's first COLORS_SOLVES solves, whose
# keys the seed fixes; CHECKED_SOLVES of them, drawn from the seed, are
# judged with their initial coloring, and the window's last besides
COLORS_SOLVES = 32
CHECKED_SOLVES = 3
# the traced window's longest length: long enough for the device's shares,
# short enough that reading its trace stays within a run's time
TRACE_SECONDS = 15.0


# --------------------------------------------------------- the manifest --

def load_json(bench_dir: Path, kind: str, name: str) -> dict:
    """``<bench_dir>/<kind>/<name>.json``."""
    return json.loads((bench_dir / kind / f"{name}.json").read_text())


def load_reader(bench_dir: Path, name: str):
    """The ``read`` function of ``<bench_dir>/metrics/<name>.py``."""
    path = bench_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "colorbench_metric_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class Cell:
    """A workload of the manifest with its files and its metrics."""

    name: str
    chips: int
    config: dict
    traffic: dict
    metrics: list        # manifest entries, in manifest order
    readers: dict        # metric name -> read


def load_cell(manifest_path: Path, bench_dir: Path, workload: str,
              trace: bool) -> Cell:
    """The cell ``workload`` of the manifest: with ``trace`` its per-layer
    metrics, else its end-to-end ones (an entry with ``workloads`` applies
    to the cells it lists, one without to every cell)."""
    manifest = json.loads(Path(manifest_path).read_text())
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; known: {sorted(cells)}")
    w = cells[workload]
    kind = "per_layer" if trace else "end_to_end"
    metrics = [m for m in manifest[kind]
               if workload in m.get("workloads", [workload])]
    return Cell(name=workload, chips=int(w["chips"]),
                config=load_json(bench_dir, "configs", w["config"]),
                traffic=load_json(bench_dir, "traffic", w["traffic"]),
                metrics=metrics,
                readers={m["name"]: load_reader(bench_dir, m["name"])
                         for m in metrics})


# --------------------------------------------------------------- the run --

@dataclasses.dataclass
class Run:
    """What a metric reader reads.  Times in seconds."""

    config: dict
    traffic: dict
    n: int                 # vertices
    nnz: int               # adjacency entries (both directions)
    n_iters: int           # recoloring iterations of a solve (K)
    setup_s: float
    partition_s: float
    to_device_s: float
    latencies: list        # every solve of the window, in order
    window_s: float
    stage_s: dict          # stage name -> its wall time summed over them
    colors: list           # distinct colors of the first solves' results
    trace: tracing.Trace | None


def forbidden_modules() -> list:
    """The loaded modules whose top-level name is forbidden."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def nvidia_smi(query: str) -> str:
    """The card's ``nvidia-smi --query-gpu=<query>`` line."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read: {e}"
    lines = out.stdout.strip().splitlines()
    return lines[0] if lines else f"not read: {out.stderr.strip()}"


class StageClock:
    """The spans of a solve's stages as host clocks: ``clock(name)`` is a
    context that adds its wall time to ``seconds[name]``.  Each stage ends
    in a read of the device, so its wall time covers its device work."""

    def __init__(self):
        self.seconds = {}

    @contextlib.contextmanager
    def __call__(self, name):
        t = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[name] = (self.seconds.get(name, 0.0)
                                  + time.perf_counter() - t)


def _profiler_span(name):
    from torch.profiler import record_function
    return record_function(tracing.SPAN_PREFIX + name)


@dataclasses.dataclass
class Window:
    """What one window of solves gave."""

    latencies: list = dataclasses.field(default_factory=list)
    finals: dict = dataclasses.field(default_factory=dict)  # i -> (n,) colors
    initials: dict = dataclasses.field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    seconds: float = 0.0
    last: tuple | None = None     # (i, final view) of the last solve


def run_window(prog, seed: int, seconds: float, span, index, keep: set,
               checked: set, err) -> Window:
    """Solves back to back from one caller until ``seconds`` have passed:
    solve ``i`` with key ``key(seed, i)``; the final colors of the solves
    in ``keep`` and the initial colors of those in ``checked`` are kept."""
    w = Window()
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < seconds:
        w.attempted += 1
        t = time.perf_counter()
        hook = None
        if i in checked:
            def hook(v, i=i):
                w.initials[i] = v.reshape(-1)[index]
        try:
            with span("solve"):
                view, _ = prog.solve(key(seed, i), span, hook)
        except Exception:                                # counted as failed
            w.failed += 1
            if w.failed == 1:
                traceback.print_exc(file=err)
            i += 1
            continue
        w.latencies.append(time.perf_counter() - t)
        if i in keep:
            w.finals[i] = view.reshape(-1)[index]
        w.last = (i, view)
        i += 1
    w.seconds = time.perf_counter() - t0
    return w


def judge(w: Window, checked: set, indptr, indices, config: dict,
          n_iters: int, max_colors: int) -> tuple:
    """The reference's numbers over the judged solves (each the largest
    over them) and the count of solves judged wrong.  A solve whose
    initial coloring was not kept is judged on its final colors alone."""
    numbers = {name: 0 for name in LIMITS}
    judged = wrong = 0
    for i in sorted(checked & w.finals.keys()):
        fin = w.finals[i].long()
        if i in w.initials:
            got = reference.judge(w.initials[i].long(), fin, indptr, indices,
                                  distance=config["distance"],
                                  n_iters=n_iters, max_colors=max_colors)
        else:
            got = {"final.out_of_range": reference.out_of_range(fin,
                                                                max_colors),
                   "final.conflicts": reference.conflicts(
                       fin, indptr, indices, config["distance"])}
        judged += 1
        wrong += any(v > LIMITS[k] for k, v in got.items())
        for k, v in got.items():
            numbers[k] = max(numbers[k], v)
    return numbers, judged, wrong


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, err=sys.stderr) -> dict | None:
    """Run ``cell`` once; returns the result (None when a forbidden module
    was loaded, which is reported on ``err``).

    With ``trace`` a second window of the same solves (at most
    ``TRACE_SECONDS`` long) follows the first, under the profiler, with a
    span around the window, each solve and each stage: the first window
    gives the host clocks, the second the trace."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    config, traffic = cell.config, cell.traffic

    # ------------------------------------------------------------ set-up
    indptr_d, indices_d = graphs.make_graph(config, seed, device)
    indptr, indices = indptr_d.cpu().numpy(), indices_d.cpu().numpy()
    n, nnz = len(indptr) - 1, len(indices)
    del indptr_d, indices_d
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    prog = Program(config, traffic, indptr, indices, device)
    P, n_iters = config["shards"], prog.cfg.n_iters
    mc = prog.cfg.color.max_colors
    t_warm, j = time.perf_counter(), 0
    while j < WARMUP_SOLVES or time.perf_counter() - t_warm < WARMUP_SECONDS:
        prog.solve(key(seed, WARMUP_KEY - j), StageClock())
        j += 1
    setup_s = time.perf_counter() - t_start

    # ----------------------------------------------------------- windows
    index = reference.slot_index(n, P, prog.n_slots, device)
    n_kept = COLORS_SOLVES
    checked = set(np.random.default_rng(seed).choice(
        n_kept, CHECKED_SOLVES, replace=False).tolist())
    stages = StageClock()
    w = run_window(prog, seed, seconds, stages, index, set(range(n_kept)),
                   checked, err)
    prof = tw = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CPU]
                       + ([ProfilerActivity.CUDA] if cuda else []))
        with prof:
            with _profiler_span("window"):
                tw = run_window(prog, seed, min(seconds, TRACE_SECONDS),
                                _profiler_span, index, set(), set(), err)
    clocks = (nvidia_smi("clocks.sm,clocks.mem,temperature.gpu,power.draw")
              if cuda else "")
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    loaded = forbidden_modules()
    if loaded:
        print(f"forbidden modules loaded: {', '.join(loaded)}", file=err)
        return None
    # the last solve of each window is judged as well, on its final colors
    for win in (w, tw):
        if win is not None and win.last is not None:
            win.finals.setdefault(win.last[0],
                                  win.last[1].reshape(-1)[index])
            win.last = None
    partition_s, to_device_s = prog.partition_s, prog.to_device_s
    prog = None                        # the program's state is freed
    if cuda:
        torch.cuda.empty_cache()

    # ------------------------------------------------------- the check
    t_ref = time.perf_counter()
    indptr_t = torch.from_numpy(indptr).to(device)
    indices_t = torch.from_numpy(indices).to(device)
    numbers, judged, wrong = judge(w, checked | {max(w.finals, default=-1)},
                                   indptr_t, indices_t, config, n_iters, mc)
    failed = w.failed + wrong
    attempted = w.attempted
    if tw is not None:
        t_numbers, t_judged, t_wrong = judge(
            tw, set(tw.finals), indptr_t, indices_t, config, n_iters, mc)
        judged += t_judged
        failed += tw.failed + t_wrong
        attempted += tw.attempted
        numbers = {k: max(v, t_numbers[k]) for k, v in numbers.items()}
    colors = [int(torch.unique(c[c > 0]).numel())
              for i, c in sorted(w.finals.items()) if i < n_kept]

    # ----------------------------------------------------- the metrics
    t_trace = time.perf_counter()
    run = Run(config=config, traffic=traffic, n=n, nnz=nnz, n_iters=n_iters,
              setup_s=setup_s, partition_s=partition_s,
              to_device_s=to_device_s, latencies=w.latencies,
              window_s=w.seconds, stage_s=stages.seconds, colors=colors,
              trace=tracing.from_profiler(prof) if trace else None)
    t_metrics = time.perf_counter()
    metrics = {}
    for m in cell.metrics:
        value = cell.readers[m["name"]](run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else device.type,
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    if cuda:
        dev["card"] = nvidia_smi("name,power.limit")
    result = {"correct": failed == 0 and judged > 0, "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": dev}
    if run.trace is not None:
        lo, hi = run.trace.window
        dev["busy_s"] = tracing.covered_ns(
            *tracing.union(run.trace.device, lo, hi),
            run.trace.spans["window"]) / 1e9
        dev["window_s"] = (hi - lo) / 1e9
        result["breakdown"] = {"device_ops": tracing.device_ops(run.trace),
                               "idle_gaps": tracing.idle_gaps(run.trace)}
    lat = sorted(w.latencies)
    print(f"set-up {setup_s:.3f} s; window {w.seconds:.3f} s, "
          f"{len(lat)} solves, first three "
          f"{[round(x * 1e3, 3) for x in w.latencies[:3]]} ms, median "
          f"{lat[len(lat) // 2] * 1e3 if lat else 0:.3f} ms; "
          + (f"traced window {tw.seconds:.3f} s, {len(tw.latencies)} solves; "
             if tw is not None else "")
          + f"reference {t_trace - t_ref:.3f} s for {judged} solves; trace "
          f"read {t_metrics - t_trace:.3f} s; metrics "
          f"{time.perf_counter() - t_metrics:.3f} s; card after the window: "
          f"{clocks}", file=err)
    result["checks"] = {
        "solves_judged": {"value": judged, "limit": "at least 1"},
        **{k: {"value": v, "limit": LIMITS[k]} for k, v in numbers.items()}}
    return result


def print_result(result: dict, out=sys.stdout, err=sys.stderr) -> None:
    """The checks as the last lines on ``err``, the result as the last
    line on ``out``."""
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=err)
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()
