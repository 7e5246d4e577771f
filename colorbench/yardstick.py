"""The yardstick: the card's peaks, the least bytes of the work, and the
statistics of the end-to-end metrics.  Nothing here reads the program.
"""
from __future__ import annotations

import statistics

# NVIDIA H100 SXM data sheet: HBM3 bandwidth, at the full 700 W limit
PEAK_HBM_BYTES_PER_S = 3.35e12


def pass_bytes(n: int, nnz: int) -> int:
    """The least bytes of one pass over a CSR graph of ``n`` vertices and
    ``nnz`` adjacency entries: the neighbour ids and the row offsets read
    once, each vertex's color read once and written once, all at 4 bytes.
    A lower bound whatever the layout, so a share of the roofline built on
    it cannot pass 100%."""
    return 4 * nnz + 4 * (n + 1) + 8 * n


def roofline_pct(n_bytes: float, busy_s: float) -> float | None:
    """The share of the HBM roofline that ``n_bytes`` moved in ``busy_s``
    seconds of device time reaches, in %; None without device time."""
    if busy_s <= 0:
        return None
    return 100.0 * n_bytes / PEAK_HBM_BYTES_PER_S / busy_s


def p90(values: list) -> float:
    """The 90th percentile (``statistics.quantiles``, inclusive method)."""
    if len(values) == 1:
        return float(values[0])
    return statistics.quantiles(values, n=10, method="inclusive")[-1]
