"""attn_roofline.train: share (%) of kernels D and F's bound in their
device time, pack and c passes included."""

from portbench.harness import readers


def read(ctx):
    return readers.roofline(ctx, "train")
