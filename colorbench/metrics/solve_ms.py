"""solve_ms: the window's wall time over the solves it completed."""


def read(run):
    if not run.latencies:
        return None
    return 1e3 * run.window_s / len(run.latencies)
