"""partition_s: host clock around ``partition_graph`` in set-up."""


def read(run):
    return run.partition_s
