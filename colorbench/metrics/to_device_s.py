"""to_device_s: host clock around ``to_device`` and a synchronize."""


def read(run):
    return run.to_device_s
