"""kernels.recolor_roofline_pct: the recoloring loop's share of the HBM
roofline.  Bytes: K least passes over the graph a solve
(``yardstick.pass_bytes`` of the cell's CSR), whatever implements them.
Time: the device's kernel time inside the ``recolor`` spans of the traced
window.  Nothing without recoloring iterations."""
from colorbench import trace, yardstick


def read(run):
    if (run.n_iters == 0 or run.trace is None
            or "recolor" not in run.trace.spans):
        return None
    spans = run.trace.spans["recolor"]
    busy = trace.busy_ns(run.trace, spans) / 1e9
    return yardstick.roofline_pct(
        len(spans) * run.n_iters * yardstick.pass_bytes(run.n, run.nnz), busy)
