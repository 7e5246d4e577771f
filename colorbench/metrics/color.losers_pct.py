"""color.losers_pct: the vertices the speculative coloring's repairs
uncolored, as a share of the vertices a solve colors once: the program's
counter ``color.losers`` over the traced window, over n times its
solves.  Each loser is colored again, so this is work done twice."""
from colorbench import program_spans


def read(run):
    losers = program_spans.counter(run, "color.losers")
    if losers is None:
        return None
    return 100.0 * losers / (run.n * program_spans.solves(run))
