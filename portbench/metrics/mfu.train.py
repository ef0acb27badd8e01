"""mfu.train: the stage-2 step's model FLOPs a second over the window, as a
share (%) of the TF32 peak."""

from portbench.harness import readers


def read(ctx):
    return readers.mfu(ctx, "train")
