"""Build the hand-written CUDA kernels with ``nvcc`` at first use.

Each source in ``csrc/`` compiles on its own into a shared library with a
plain C interface (loaded with ``ctypes``), for ``sm_90a`` (Hopper).  A
library is named after a hash of its source and the flags, under
``build/repro_torch_kernels/`` at the repository root, so an edited source
rebuilds and an unchanged one is reused; the hash covers every header in
``csrc/`` too (``select_common.cuh`` is shared by the four select
kernels, ``select_run.cuh`` by the two run kernels and the two
sequential kernels, ``greedy_run.cuh`` by the two sequential kernels,
``conflict_frontier.cuh`` by the two frontier conflict kernels).  ``build()`` starts
one ``nvcc`` per missing library, all at once, and waits for all of them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = {"color_select": "color_select.cu", "conflict": "conflict.cu",
           "color_select_d2": "color_select_d2.cu",
           "conflict_d2": "conflict_d2.cu", "select_run": "select_run.cu",
           "select_run_d2": "select_run_d2.cu",
           "conflict_frontier": "conflict_frontier.cu",
           "conflict_frontier_d2": "conflict_frontier_d2.cu",
           "greedy_run": "greedy_run.cu", "greedy_run_d2": "greedy_run_d2.cu",
           "exchange_push": "exchange_push.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on the
    PATH, or ``/usr/local/cuda/bin/nvcc``."""
    cands = [Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc"
             if "CUDA_HOME" in os.environ else None,
             shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c is not None and Path(c).is_file():
            return str(c)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the CUDA kernels")


def library_path(name: str) -> Path:
    """Where kernel ``name``'s library lives: named after a hash of its
    source, of every ``csrc/*.cuh`` header (by name and content) and of
    the compiler flags."""
    h = hashlib.sha256((CSRC / SOURCES[name]).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=tuple(SOURCES)) -> dict[str, str]:
    """Compile every missing library of ``names`` in parallel.

    Returns ``{name: compiler log}`` (``-Xptxas=-v`` register and
    shared-memory report; the log is kept beside the library).  Raises
    with the compiler's output if any build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{name} (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    logs = {}
    for name in names:
        log = library_path(name).with_suffix(".log")
        logs[name] = log.read_text() if log.exists() else ""
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if missing."""
    if name not in _LIBS:
        build((name,))
        _LIBS[name] = ctypes.CDLL(str(library_path(name)))
    return _LIBS[name]
