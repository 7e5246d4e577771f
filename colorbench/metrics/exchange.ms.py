"""exchange.ms: the host's time in the boundary exchange a solve: the
spans ``repro_torch.exchange`` (one exchange's gather and scatter) and
``repro_torch.exchange.build`` (building its index arrays), summed over
the traced window."""
from colorbench import program_spans


def read(run):
    calls = program_spans.ms_per_solve(run, "exchange")
    builds = program_spans.ms_per_solve(run, "exchange.build")
    if calls is None and builds is None:
        return None
    return (calls or 0.0) + (builds or 0.0)
