"""extract_dev_ms.serve: device ms a batch inside the hook ranges around
the event and image extractors' forwards."""

from portbench.harness import readers


def read(ctx):
    return readers.range_dev_ms(ctx, "serve", "extract.event", "extract.image")
