"""Fault-tolerant checkpointing: atomic, checksummed, restorable onto a
mesh (the port of ``repro.train.checkpoint``, in its on-disk format).

Layout (one directory per step):

  ckpt_dir/step_000123/
    manifest.json      {step, keys, shapes, dtypes, crc32s, wallclock}
    <flatkey>.npy      one array per tree leaf (paths joined with '.')

Writes go to ``step_<n>.tmp`` then ``os.rename``: a crash mid-save never
corrupts the latest valid checkpoint, and restore picks the newest
manifest whose checksums verify.  The files are the reference's, byte for
byte: a bfloat16 leaf is its raw 2-byte words under the ``.npy`` descr
``'<V2'`` (what numpy writes for ml_dtypes' bfloat16, which the port does
not import) and ``"bfloat16"`` in the manifest; restore turns such data
back into ``torch.bfloat16`` by the manifest's dtype.

On a built ``DeviceMesh`` with a spec tree (``specs``: ``plan.spec`` per
leaf of the parts that are sharded), ``save`` gathers the sharded leaves
one at a time on every rank (``parallel.shard.unshard``), rank 0 copies
each to the host before the next, and rank 0 writes: the files are
those of the one-device tree, so a checkpoint moves between the packages
and between mesh shapes.  ``restore(..., mesh=, specs=)`` gives each rank
its shard of every leaf with a spec, and the other leaves whole: the
reference's elastic re-mesh restore.  The caller makes every rank wait for
rank 0's write before a restore (``Trainer.restore``).

``save_async`` copies the tree to the host synchronously (a copy even for
CPU tensors, so a later in-place update cannot reach it) and writes on a
background thread, so the train loop overlaps I/O with compute.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
import zlib
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.comm import shard_uniform
from repro_torch.parallel.shard import as_rank_mesh, shard_of, unshard

_SEP = "."
_BF16 = "bfloat16"


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}{_SEP}"))
        return out
    out[prefix[:-1]] = tree
    return out


def _unflatten(flat: dict):
    root: dict = {}
    for key, v in flat.items():
        parts = key.split(_SEP)
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return root


def _host(v) -> np.ndarray:
    """A leaf as a numpy array of its own memory: a tensor is copied to the
    host (bfloat16 as ``V2`` words), an array is copied."""
    if isinstance(v, torch.Tensor):
        t = v.detach().to("cpu", copy=True).contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2")
        return t.numpy()
    return np.array(v)


def _crc(a: np.ndarray) -> int:
    """crc32 of the array's bytes in C order (read in place when the array
    is contiguous)."""
    a = a if a.flags.c_contiguous else np.ascontiguousarray(a)
    return zlib.crc32(a.reshape(-1).view(np.uint8)) & 0xFFFFFFFF


def _write_npy(path: Path, a: np.ndarray, bf16: bool) -> None:
    if not bf16:
        np.save(path, a)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False, "shape": a.shape})
        f.write(a.tobytes())


def _snapshot(tree, mesh=None, specs=None) -> tuple[dict, set] | None:
    """(flat host arrays, the keys of bfloat16 leaves).  On a built mesh
    with ``specs`` each sharded leaf is gathered (a collective of every
    rank) and copied to the host one leaf at a time, so at most one whole
    leaf is on a device; rank 0 keeps the copies and the other ranks
    return ``None``."""
    rm = as_rank_mesh(mesh) if specs is not None else None
    writer = rm is None or dist.get_rank() == 0
    flat_specs = _flatten(specs) if rm is not None else {}
    flat, bf16 = {}, set()
    for k, v in _flatten(tree).items():
        if isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16:
            bf16.add(k)
        spec = shard_uniform(flat_specs.get(k))   # one tree on every rank
        if spec is not None:
            v = unshard(v, spec, rm)
        if writer:
            flat[k] = _host(v)
    return (flat, bf16) if writer else None


def _save_flat(ckpt_dir, step: int, flat: dict, bf16: set, keep: int,
               extra: dict | None) -> Path:
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    tmp = ckpt_dir / f"step_{step:08d}.tmp"
    final = ckpt_dir / f"step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    manifest = dict(step=step, wallclock=time.time(), extra=extra or {},
                    keys={}, format=1)
    for k, v in flat.items():
        _write_npy(tmp / f"{k}.npy", v, k in bf16)
        manifest["keys"][k] = dict(shape=list(v.shape),
                                   dtype=_BF16 if k in bf16 else str(v.dtype),
                                   crc32=_crc(v))
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(ckpt_dir, keep)
    return final


def save(ckpt_dir, step: int, tree, *, keep: int = 3,
         extra: dict | None = None, mesh=None, specs=None) -> Path | None:
    """Atomic synchronous checkpoint of a nested dict of tensors/arrays
    (on a mesh: of its gathered leaves, written by rank 0; the other
    ranks return ``None``)."""
    snap = _snapshot(tree, mesh, specs)
    if snap is None:
        return None
    return _save_flat(ckpt_dir, step, *snap, keep, extra)


def save_async(ckpt_dir, step: int, tree, *, keep: int = 3,
               extra: dict | None = None, mesh=None,
               specs=None) -> threading.Thread | None:
    """Snapshot to host now (a copy), write on a background thread.  The
    thread's ``seconds`` is the write's duration once it has ended.  On a
    mesh the leaves are gathered now and rank 0 writes; the other ranks
    return ``None``."""
    snap = _snapshot(tree, mesh, specs)
    if snap is None:
        return None

    def write():
        t0 = time.perf_counter()
        _save_flat(ckpt_dir, step, *snap, keep, extra)
        t.seconds = time.perf_counter() - t0

    t = threading.Thread(target=write, daemon=True)
    t.seconds = None
    t.start()
    return t


def nbytes(tree) -> int:
    """Bytes of a tree's leaves (what a checkpoint of it writes, headers
    aside)."""
    return int(sum(v.numel() * v.element_size() if isinstance(v, torch.Tensor)
                   else np.asarray(v).nbytes
                   for v in _flatten(tree).values()))


def _steps(ckpt_dir: Path) -> list[Path]:
    return sorted(p for p in ckpt_dir.iterdir()
                  if p.is_dir() and p.name.startswith("step_")
                  and not p.name.endswith(".tmp"))


def _gc(ckpt_dir: Path, keep: int):
    for p in _steps(ckpt_dir)[:-keep]:
        shutil.rmtree(p, ignore_errors=True)


def _load(path: Path) -> tuple[dict, dict] | None:
    """(manifest, flat arrays) of a checkpoint whose every crc32 verifies,
    else None."""
    try:
        manifest = json.loads((path / "manifest.json").read_text())
        flat = {}
        for k, meta in manifest["keys"].items():
            flat[k] = np.load(path / f"{k}.npy")
            if _crc(flat[k]) != meta["crc32"]:
                return None
        return manifest, flat
    except Exception:
        return None


def _verify(path: Path) -> dict | None:
    got = _load(path)
    return None if got is None else got[0]


def latest_step(ckpt_dir) -> int | None:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    for p in reversed(_steps(ckpt_dir)):
        if _verify(p) is not None:
            return int(p.name.split("_")[1])
    return None


def _tensor(a: np.ndarray, dtype: str, device) -> torch.Tensor:
    a = a if a.flags.c_contiguous else a.copy(order="C")
    if dtype == _BF16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def restore(ckpt_dir, step: int | None = None, *, mesh=None, specs=None,
            device="cpu"):
    """Load the newest verified checkpoint (or ``step``'s) as a nested dict
    of tensors.  With ``mesh`` and ``specs`` the leaves land on the mesh's
    device (``data.pipeline.mesh_device``; ``device`` for a ``MeshSpec``):
    on a built ``DeviceMesh`` this rank's shard of each leaf that
    ``specs`` covers, the others whole.  Without them, every leaf whole on
    ``device`` (the CPU by default).  Returns (step, tree) or (None,
    None)."""
    from repro_torch.data.pipeline import mesh_device
    ckpt_dir = Path(ckpt_dir)
    if step is None:    # the newest that verifies, each read once
        paths = reversed(_steps(ckpt_dir)) if ckpt_dir.exists() else []
        got = next((g for g in map(_load, paths) if g is not None), None)
        if got is None:
            return None, None
    else:
        path = ckpt_dir / f"step_{step:08d}"
        got = _load(path)
        if got is None:
            raise IOError(f"checkpoint {path} failed verification")
    manifest, flat = got
    placed = mesh is not None and specs is not None
    dev = mesh_device(mesh, device) if placed else torch.device(device)
    rm = as_rank_mesh(mesh) if placed else None
    flat_specs = _flatten(specs) if rm is not None else {}

    def leaf(k, meta):
        if k not in flat_specs:
            return _tensor(flat[k], meta["dtype"], dev)
        return shard_of(_tensor(flat[k], meta["dtype"], "cpu"),
                        flat_specs[k], rm).to(dev)
    return manifest["step"], _unflatten({
        k: leaf(k, meta) for k, meta in manifest["keys"].items()})
