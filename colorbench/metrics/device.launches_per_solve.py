"""device.launches_per_solve: the device kernels the profiler saw in the
traced window, whatever their names, divided by the solves."""


def read(run):
    if run.trace is None or "solve" not in run.trace.spans:
        return None
    lo, hi = run.trace.window
    n = len(run.trace.kernels().within(lo, hi))
    return n / len(run.trace.spans["solve"]) if n else None
