"""host.reads_per_solve: the blocking device-to-host reads a solve, each one
``repro_torch.read.<site>`` span in the traced window."""
from colorbench import program_spans


def read(run):
    return program_spans.count_per_solve(run, "read.", prefix=True)
