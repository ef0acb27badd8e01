"""match_dev_ms.serve: device ms a batch inside the hook range around
LightGlue's forward."""

from portbench.harness import readers


def read(ctx):
    return readers.range_dev_ms(ctx, "serve", "match")
