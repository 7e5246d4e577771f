"""kernels.color_roofline_pct: the speculative coloring's share of the HBM
roofline.  Bytes: one least pass over the graph a solve
(``yardstick.pass_bytes`` of the cell's CSR), whatever implements it.
Time: the device's kernel time (the union of kernel intervals) inside the
``color`` spans of the traced window."""
from colorbench import trace, yardstick


def read(run):
    if run.trace is None or "color" not in run.trace.spans:
        return None
    spans = run.trace.spans["color"]
    busy = trace.busy_ns(run.trace, spans) / 1e9
    return yardstick.roofline_pct(
        len(spans) * yardstick.pass_bytes(run.n, run.nnz), busy)
