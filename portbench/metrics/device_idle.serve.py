"""device_idle.serve: share (%) of the traced serving window in which no
device operation ran."""

from portbench.harness import readers


def read(ctx):
    return readers.device_idle(ctx, "serve")
