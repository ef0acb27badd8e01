"""attn_roofline.serve: share (%) of kernels A and B's bound (operations
over the TF32 peak for float32) in their device time, pack passes
included."""

from portbench.harness import readers


def read(ctx):
    return readers.roofline(ctx, "serve")
