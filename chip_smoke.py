"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (each prints one line with its seconds; any failure exits nonzero
before the final line):

1. card and build — the ``nvidia-smi`` name/power-limit query, then the
   hand-written CUDA kernels built with ``nvcc`` from ``src/repro_torch``;
2. kernels against their plain PyTorch versions on the card — random
   tiles with out-of-range colors, the saturation rows, and the main-path
   shapes (speculative tiles 64x128 rows, recolor chunks 64x256 rows,
   conflict chunks 64x512 rows, MAXD=678, max_colors=1024); bitwise equal,
   with each kernel's time, the plain version's time and the bytes bound;
3. the main path at full size — ``rmat_good(20, 8, seed=1)`` on P=64
   shards, the "quality" preset (Random-X X=10, Internal-First, ND
   recoloring) with K=8 iterations, through ``pipeline_sim`` on the GPU; the
   coloring must be valid and both kernels must have launched (counted in
   this run); then the same run again under ``torch.profiler`` for the
   device-time breakdown;
4. cross-check — ``rmat_good(18, 8, seed=2)`` at P=16 with the kernels and
   with ``backend="torch"``, under the sparse and all-gather exchanges:
   views, color stats and histories bitwise equal (the wire bytes differ
   between the schemes by design; the padding of unused ghost slots, which
   no vertex reads, differs between the schemes too).

Then the ``kernels`` JSON line, the ``nvidia-smi`` line and, last, the
result line.
"""
from __future__ import annotations

import dataclasses
import json
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


def phase(name: str, t0: float, detail: str = "") -> None:
    print(f"[phase] {name}: {time.perf_counter() - t0:.3f} s {detail}".rstrip(),
          flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` launches (CUDA events)."""
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
    """Phase 2: every kernel against its plain version; returns the kernels
    line's measured fields."""
    gen = np.random.default_rng(0)
    selections = ((ops.FIRST_FIT, 0), (ops.STAGGERED, 0), (ops.RANDOM_X, 10))

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
        for sel, x in selections + ((ops.RANDOM_X, 7),):
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
    for sel, x in selections:
        got = select(rows, ones, None, forty, sel, x, "cuda", mc)
        check(got.tolist() == [mc - 1, 5, mc - 2],
              f"saturation rows {sel}: {got.tolist()}")

    out = {}
    lines = []
    for where, n_rows in TILE_ROWS.items():
        tile, act, rand, off = main_path_tile(gen, n_rows, dev)
        n_act = int(act.sum())
        for sel, x in selections:
            got = select(tile, act, rand, off, sel, x, "cuda")
            want = select(tile, act, rand, off, sel, x, "torch")
            err = int((got - want).abs().max())
            check(err == 0, f"select {sel} at {where} shape ({n_rows}, {MAXD})")
            ms = cuda_ms(lambda: select(tile, act, rand, off, sel, x, "cuda"),
                         50)
            plain = cuda_ms(
                lambda: select(tile, act, rand, off, sel, x, "torch"), 3)
            n_bytes = n_act * (MAXD * 4 + 4) + n_rows * 8
            b, by = bound_ms(n_bytes, n_act * MAXD * 4)
            lines.append(f"color_select {sel:9s} {where} ({n_rows}x{MAXD}): "
                         f"kernel {ms:.4f} ms, plain {plain:.4f} ms, "
                         f"bound {b:.4f} ms ({by})")
            # the kernels line reports the speculative tiles' Random-X call,
            # the main path's color_select (the recolor chunks' First Fit is
            # on the lines above)
            if sel == ops.RANDOM_X and n_rows == TILE_ROWS["speculative tile"]:
                out["color_select"] = dict(ms=ms, plain_ms=plain, bound=b,
                                           by=by, err=err)

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
    n_live = int((act & (myc > 0)).sum())
    ms = cuda_ms(lambda: conf("cuda"), 50)
    plain = cuda_ms(lambda: conf("torch"), 3)
    b, by = bound_ms(n_live * (MAXD * 8 + 4) + CONFLICT_ROWS * 12,
                     n_live * MAXD * 3)
    lines.append(f"conflict  conflict chunk ({CONFLICT_ROWS}x{MAXD}): kernel "
                 f"{ms:.4f} ms, plain {plain:.4f} ms, bound {b:.4f} ms ({by}), "
                 f"{int(got.sum())} losers")
    out["conflict"] = dict(ms=ms, plain_ms=plain, bound=b, by=by, err=err)
    for line in lines:
        print("  " + line)
    return out


def stage_seconds(res) -> str:
    return ", ".join(f"{k} {v:.3f} s" for k, v in res["seconds"].items())


def phase_main_path(core, ops, dev) -> None:
    """Phase 3: the paper's headline experiment at full size."""
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
    torch.cuda.reset_peak_memory_stats(dev)
    for k in ops.KERNELS:
        k.launches = 0
    view, res = core.pipeline_sim(pg, order, cfg, device=dev)
    launches = {k.name: k.launches for k in ops.KERNELS}
    peak = torch.cuda.max_memory_allocated(dev)
    st = core.check_coloring(g, core.colors_from_views(pg, view))
    c = res["color"]
    print(f"  initial: n_colors_distinct {c['n_colors_distinct']}, "
          f"n_rounds {c['n_rounds']}, n_exchanges {c['n_exchanges']}, "
          f"wire_bytes {c['wire_bytes']}")
    for h in res["history"]:
        print(f"  iteration {h['iteration']}: n_colors_distinct "
              f"{h['n_colors_distinct']}, n_exchanges {h['n_exchanges']}, "
              f"wire_bytes {h['wire_bytes']}")
    print(f"  stages: {stage_seconds(res)}; peak device memory "
          f"{peak / 2**30:.3f} GiB; launches {launches}; valid {st['valid']}, "
          f"colors {st['n_colors']}")
    check(st["valid"], f"main-path coloring invalid: {st}")
    check(res["n_iters_run"] == MAIN_K, "main path ran fewer iterations")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} never launched on the main path")
    profile_main_path(core, pg, order, cfg, dev, res)
    return launches


def profile_main_path(core, pg, order, cfg, dev, res) -> None:
    """Where the time goes: the main path once more under torch.profiler
    (its launches are not counted).  Device time is summed over the
    device-side events; the idle share compares the device time of the
    color and recolor stages with their wall time in the unprofiled run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, res_p = core.pipeline_sim(pg, order, cfg, device=dev)
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events) / 1e6
    h2d = sum(e.self_device_time_total for e in events
              if "Memcpy" in e.key) / 1e6
    ours = {k: sum(e.self_device_time_total for e in events
                   if k + "_kernel" in e.key) / 1e6
            for k in ("color_select", "conflict")}
    loop_wall = res["seconds"]["color"] + res["seconds"]["recolor"]
    print(f"  profiled repeat: {stage_seconds(res_p)}; device busy "
          f"{busy:.4f} s, of it host->device copies {h2d:.4f} s, "
          f"color_select {ours['color_select']:.4f} s, conflict "
          f"{ours['conflict']:.4f} s; color+recolor device time "
          f"{busy - h2d:.4f} s over {loop_wall:.4f} s wall unprofiled "
          f"(device idle {1 - (busy - h2d) / loop_wall:.3f})")
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:10]
    for e in top:
        print(f"    {e.self_device_time_total / 1e3:10.3f} ms  {e.count:6d}x  "
              f"{e.key[:90]}")


def phase_cross_check(core, dev) -> None:
    """Phase 4: kernels vs plain versions, sparse vs all-gather."""
    from repro_torch.core import presets
    g = core.rmat.rmat_good(CROSS_SCALE, 8, seed=2)
    pg = core.partition_graph(g, CROSS_P)
    order = core.compute_order(pg, core.ordering.INTERNAL_FIRST)
    base = presets.pipeline_config(presets.quality(x=10), n_iters=CROSS_K)
    runs = {}
    for scheme in (core.SPARSE, core.ALLGATHER):
        for backend in ("auto", "torch"):
            cfg = dataclasses.replace(
                base, color=dataclasses.replace(base.color, scheme=scheme,
                                                backend=backend),
                recolor=dataclasses.replace(base.recolor, scheme=scheme,
                                            backend=backend))
            view, res = core.pipeline_sim(pg, order, cfg, device=dev)
            runs[scheme, backend] = (view, res)
            print(f"  {scheme:9s} {'kernels' if backend == 'auto' else 'plain':7s}"
                  f": {stage_seconds(res)}; colors "
                  f"{res['history'][-1]['n_colors_distinct']}", flush=True)
    st = core.check_coloring(g, core.colors_from_views(pg, runs[core.SPARSE,
                                                                "auto"][0]))
    check(st["valid"], "cross-check coloring invalid")
    no_bytes = lambda d: {k: v for k, v in d.items() if k != "wire_bytes"}
    for scheme in (core.SPARSE, core.ALLGATHER):
        (v1, r1), (v2, r2) = runs[scheme, "auto"], runs[scheme, "torch"]
        check(torch.equal(v1, v2), f"{scheme}: kernel and plain views differ")
        check(r1["color"] == r2["color"] and r1["history"] == r2["history"],
              f"{scheme}: kernel and plain stats differ")
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
            if "registers" in line or "smem" in line.lower():
                print(f"  nvcc {name}: {line.strip()}")
    phase("1 card and build", t)

    t = time.perf_counter()
    measured = phase_kernels(ops, dev)
    phase("2 kernels vs plain (bitwise)", t)

    t = time.perf_counter()
    launches = phase_main_path(core, ops, dev)
    phase(f"3 main path rmat_good({MAIN_SCALE}) P={MAIN_P} K={MAIN_K}", t)

    t = time.perf_counter()
    phase_cross_check(core, dev)
    phase(f"4 cross-check rmat_good({CROSS_SCALE}) P={CROSS_P} K={CROSS_K} "
          "kernels/plain x sparse/allgather", t)

    kernels = []
    for name, src, line in (
            ("color_select", "src/repro_torch/kernels/csrc/color_select.cu",
             "src/repro/kernels/firstfit.py:172"),
            ("conflict", "src/repro_torch/kernels/csrc/conflict.cu",
             "src/repro/kernels/firstfit.py:240")):
        m = measured[name]
        kernels.append(dict(name=name, route="cuda", source=src, replaces=line,
                            launches=launches[name], max_abs_err=m["err"],
                            ms=m["ms"], plain_ms=m["plain_ms"],
                            bound_ms=m["bound"], bound_by=m["by"],
                            library_ms=None))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
