"""host_ms.serve: mean host ms to enqueue one served batch (copy, voxel
grid, forward; no sync) over the window."""

from portbench.harness import readers


def read(ctx):
    return readers.host_ms(ctx, "serve")
