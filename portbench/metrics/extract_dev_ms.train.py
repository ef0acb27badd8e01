"""extract_dev_ms.train: device ms a step inside the hook ranges around the
frozen extractors' forwards."""

from portbench.harness import readers


def read(ctx):
    return readers.range_dev_ms(ctx, "train", "extract.event", "extract.image")
