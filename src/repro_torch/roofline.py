"""The coloring's device-memory projection for one NVIDIA H100.

The counterpart of the reference's ``repro.roofline.coloring_memory_projection``
(same signature, same keys), reckoned for the port's own device layout:
the tensors ``core.to_device`` makes from ``PartitionedGraph.arrays()``
at the dtypes the port stores, plus the working views.  Where the two
layouts differ:

- ``gvid`` stays on the host in the port (``to_device`` does not copy it):
  0 bytes here, id-width per slot in the reference;
- ``n_local`` (one int32 per shard) is on the port's device, not in the
  reference's projection;
- ``plan=(n_rounds, max_send)`` adds the sparse exchange's plan arrays
  (``send_slot``, ``ghost_shift`` + ``ghost_pos``, ``shift_to_round``,
  ``round_widths``), which ``to_device(sparse=True)`` copies; the
  reference leaves them out;
- ``edge_frac`` scales the CSR arrays to a partition's measured
  ``m_local_max`` (1.0, the default, is the reference's ``n_local * maxd``
  upper bound);
- ``promoted_extra_bytes`` counts ``prio`` only (``gvid`` is not on the
  device).

The reference's HLO parse (``analyze_hlo``) has no torch counterpart:
the LM dry run (``launch.dryrun``) counts the same quantities while it
runs a step on ``meta`` tensors (matmul FLOPs and operand bytes, and each
collective's bytes), and ``roofline_terms`` turns them into the three
per-rank times against an H100 SXM's data-sheet peaks.  ``model_flops``
is the reference's count of an LM step (6·N·D to train, 2·N·D to infer),
which ``chip_smoke.py`` divides by the training step's time.
"""
from __future__ import annotations

import math

import numpy as np

from repro_torch.core.graph import id_policy

#: device memory of one NVIDIA H100 SXM5 80GB (NVIDIA's data sheet: 80 GB)
H100_80GB_HBM_BYTES = 80 * 10**9
HBM_BYTES = H100_80GB_HBM_BYTES
#: dense bf16 tensor-core rate of one H100 SXM5 (NVIDIA's data sheet, at
#: its 700 W limit)
H100_BF16_FLOPS = 989.4e12
#: HBM3 bandwidth of one H100 SXM5 (NVIDIA's data sheet)
H100_HBM_BW = 3.35e12
#: NVLink 4 of one H100 SXM5: 900 GB/s both ways together (NVIDIA's data
#: sheet), 450 GB/s each way
H100_NVLINK_BW = 450e9
_AR_FACTOR = 2.0           # ring all-reduce = reduce-scatter + all-gather


def _part(n: int, frac: float) -> int:
    """``int(n * frac)``, robust to a fraction read off a partition
    (``max_ghost / n_local_max`` gives back ``max_ghost``)."""
    return int(math.floor(n * frac + 1e-9))


def coloring_memory_projection(n_global: int, P: int, maxd: int, *,
                               maxd2: int = 0, ghost_frac: float = 0.5,
                               boundary_frac: float = 0.5,
                               batch: int = 1, edge_frac: float = 1.0,
                               plan: tuple | None = None) -> dict:
    """Per-shard device bytes of the port's coloring layout.

    A graph of ``n_global`` vertices block-partitioned over ``P`` shards at
    max degree ``maxd`` (``maxd2`` adds the distance-2 ELL halo), sized
    without allocating anything.  ``ghost_frac``/``boundary_frac`` model
    the halo as a fraction of the local block; ``batch`` multiplies the
    working views (one per lane); ``edge_frac`` and ``plan`` as the module
    docstring says.  Id widths come from ``core.graph.id_policy``: the slot
    arrays stay int32 at any size, and promotion past 2**31 vertices widens
    ``prio``.  Returns the per-array byte dict, the totals and the H100's
    occupancy fraction.
    """
    n_local = -(-n_global // P)
    pol = id_policy(n_global, n_local, maxd, maxd2)
    n_ghost = _part(n_local, ghost_frac)
    n_boundary = _part(n_local, boundary_frac)
    n_slots = n_local + n_ghost + 1
    m_local = _part(n_local * maxd, edge_frac)
    id_b = pol.id_itemsize
    lanes = max(batch, 1)
    per = dict(
        nbr=n_local * maxd * 4,             # ELL neighbour slots: int32
        nbr2=n_local * maxd2 * 4,           # distance-2 ELL halo
        indices=m_local * 4,                # CSR column slots: int32
        edge_src=m_local * 4,
        indptr=(n_local + 1) * 4,
        prio=n_slots * id_b,                # global priorities: id-width
        gvid=0,                             # stays on the host
        boundary=n_boundary * 4,
        ghost_tables=2 * n_ghost * 4,       # ghost_owner + ghost_slot
        degree_flags=n_local * 5,           # degree (int32) + is_internal
        n_local=4,                          # one int32 per shard
        views=n_slots * 4 * lanes,          # working color views per lane
    )
    if plan is not None:
        n_rounds, max_send = plan
        per.update(                         # padded to one slot when empty
            send_slot=max(n_rounds, 1) * max(max_send, 1) * 4,
            ghost_plan=2 * n_ghost * 4,     # ghost_shift + ghost_pos
            shift_to_round=P * 4,
            round_widths=max(n_rounds, 1) * 4)
    total = sum(per.values())
    extra = n_slots * (id_b - 4) if pol.promoted else 0
    return dict(
        n_global=int(n_global), P=int(P), n_local_max=int(n_local),
        maxd=int(maxd), maxd2=int(maxd2), batch=lanes,
        id_dtype=np.dtype(pol.id_dtype).name,
        ell_dtype=np.dtype(pol.ell_dtype).name,
        promoted=pol.promoted, promoted_extra_bytes=int(extra),
        per_shard_bytes=per, total_per_shard=int(total),
        hbm_fraction=total / HBM_BYTES, fits_hbm=total <= HBM_BYTES)


#: the projection's arrays -> the ``to_device`` tensors they count
DEVICE_ARRAYS = {
    "nbr": ("nbr",), "nbr2": ("nbr2",), "indices": ("indices",),
    "edge_src": ("edge_src",), "indptr": ("indptr",), "prio": ("prio",),
    "boundary": ("boundary",), "ghost_tables": ("ghost_owner", "ghost_slot"),
    "degree_flags": ("degree", "is_internal"), "n_local": ("n_local",),
    "send_slot": ("send_slot",), "ghost_plan": ("ghost_shift", "ghost_pos"),
    "shift_to_round": ("shift_to_round",), "round_widths": ("round_widths",),
}


def projection_of(pg, *, batch: int = 1, sparse: bool = False) -> dict:
    """The projection with a partition's own fractions (its halo, its
    edges, its plan when ``sparse``): what it says of that partition's
    ``to_device`` tensors, array by array."""
    plan = None
    if sparse:
        cp = pg.comm_plan
        plan = (len(cp.shifts), cp.max_send)
    n_local = -(-pg.n_global // pg.P)
    return coloring_memory_projection(
        pg.n_global, pg.P, pg.maxd, maxd2=pg.maxd2,
        ghost_frac=pg.max_ghost / n_local,
        boundary_frac=pg.max_boundary / n_local,
        edge_frac=pg.m_local_max / (n_local * pg.maxd), batch=batch,
        plan=plan)


def device_bytes(arrs: dict) -> dict:
    """Per-shard bytes of ``to_device``'s tensors, grouped as the
    projection names them (``DEVICE_ARRAYS``)."""
    P = next(iter(arrs.values())).shape[0]
    out = {}
    for name, keys in DEVICE_ARRAYS.items():
        if all(k in arrs for k in keys):
            out[name] = sum(arrs[k].numel() * arrs[k].element_size()
                            for k in keys) // P
    return out


def roofline_terms(flops: float, hbm_bytes: float, coll_bytes: dict) -> dict:
    """The reference's three per-rank roofline terms (seconds) and their
    keys, from a step's matmul FLOPs, matmul operand and output bytes (the
    reference's HBM-traffic proxy) and per-rank collective bytes by kind,
    against the H100 SXM's data-sheet peaks."""
    coll_eff = sum(v * (_AR_FACTOR if k == "all-reduce" else 1.0)
                   for k, v in coll_bytes.items())
    terms = dict(compute_s=flops / H100_BF16_FLOPS,
                 memory_s=hbm_bytes / H100_HBM_BW,
                 collective_s=coll_eff / H100_NVLINK_BW,
                 collective_bytes=coll_eff, flops=flops,
                 hbm_bytes=hbm_bytes)
    dom = max(("compute_s", "memory_s", "collective_s"),
              key=lambda k: terms[k])
    terms["bottleneck"] = dom.replace("_s", "")
    total = max(terms["compute_s"], terms["memory_s"], terms["collective_s"])
    terms["roofline_fraction"] = terms["compute_s"] / total if total else 0.0
    return terms


def model_flops(arch, shape) -> float:
    """MODEL_FLOPS = 6·N·D (train) / 2·N·D (inference), N = active params
    (``arch``: an ``ArchConfig``; ``shape``: a ``ShapeConfig``)."""
    n = arch.n_active_params() if arch.is_moe else arch.n_params()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    tokens = shape.global_batch  # one token per sequence
    return 2.0 * n * tokens
