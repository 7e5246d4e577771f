"""color_ms: the speculative coloring (``color_lanes``) by the host clock
around it, summed over the window and divided by the solves.  The stage
ends in a read of the device, so the clock covers its device work."""


def read(run):
    if not run.latencies or "color" not in run.stage_s:
        return None
    return 1e3 * run.stage_s["color"] / len(run.latencies)
