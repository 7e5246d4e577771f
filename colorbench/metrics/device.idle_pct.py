"""device.idle_pct: the share of the traced window in which no operation
ran on the device: 1 - (union of device intervals in the window) / window."""
from colorbench import trace


def read(run):
    if run.trace is None or not len(run.trace.device):
        return None
    lo, hi = run.trace.window
    busy = trace.covered_ns(*trace.union(run.trace.device, lo, hi),
                            run.trace.spans["window"])
    return 100.0 * (1.0 - busy / (hi - lo))
