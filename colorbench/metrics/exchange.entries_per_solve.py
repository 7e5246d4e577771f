"""exchange.entries_per_solve: the ghost entries the boundary exchanges
copied, a solve: the program's counter ``exchange.entries`` over the
traced window's solves."""
from colorbench import program_spans


def read(run):
    return program_spans.per_solve(
        run, program_spans.counter(run, "exchange.entries"))
