"""solve_p90_ms: the 90th percentile of the latency of every solve of the
window."""
from colorbench import yardstick


def read(run):
    if not run.latencies:
        return None
    return 1e3 * yardstick.p90(run.latencies)
