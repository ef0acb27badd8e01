"""repr_dev_ms.serve: device ms a batch of the kernels launched inside the
harness's range around batch_representation."""

from portbench.harness import readers


def read(ctx):
    return readers.range_dev_ms(ctx, "serve", "repr")
