"""host.read_wait_ms: the time the host blocked on the device a solve: the
spans ``repro_torch.read.<site>`` summed over the traced window."""
from colorbench import program_spans


def read(run):
    return program_spans.ms_per_solve(run, "read.", prefix=True)
