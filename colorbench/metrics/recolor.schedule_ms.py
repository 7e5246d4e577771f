"""recolor.schedule_ms: the host's time building the recoloring
schedules a solve, its blocking read left out: the spans
``repro_torch.recolor.schedule`` less their ``repro_torch.read.schedule``
children, summed over the traced window, per solve."""
from colorbench import program_spans


def read(run):
    built = program_spans.ms_per_solve(run, "recolor.schedule")
    if built is None:
        return None
    return built - (program_spans.ms_per_solve(run, "read.schedule") or 0.0)
