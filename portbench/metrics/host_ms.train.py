"""host_ms.train: mean host ms to enqueue one stage-2 step over the window."""

from portbench.harness import readers


def read(ctx):
    return readers.host_ms(ctx, "train")
