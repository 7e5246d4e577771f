"""setup_s: from the start of the process to the first solve of the
window (graph generation, partition, move to the device, warm-up)."""


def read(run):
    return run.setup_s
