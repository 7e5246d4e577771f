"""recolor_ms: the recoloring loop (``recolor_loop``) by the host clock
around it, summed over the window and divided by the solves; nothing
without recoloring iterations.  The loop ends in a read of the device, so
the clock covers its device work."""


def read(run):
    if run.n_iters == 0 or not run.latencies or "recolor" not in run.stage_s:
        return None
    return 1e3 * run.stage_s["recolor"] / len(run.latencies)
