"""color.rounds_per_solve: the speculative coloring's rounds a solve, each
one ``repro_torch.color.round`` span of ``_speculate`` (its supersteps'
runs and exchanges, then its conflict repair) in the traced window."""
from colorbench import program_spans


def read(run):
    return program_spans.count_per_solve(run, "color.round")
