"""device_idle.train: share (%) of the traced training window in which no
device operation ran."""

from portbench.harness import readers


def read(ctx):
    return readers.device_idle(ctx, "train")
