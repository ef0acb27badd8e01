"""The plain reference of `silk_lg` (configs/silk_lg.json): EI-SiLK-LG,
the cell-1 event VGG (`vgg_np`), the frozen SiLK and LightGlue through its
input projection, as `reference.eim` wires `reference.nets`."""

from portbench.reference.eim import (extract_pair, match,  # noqa: F401
                                     representation, stage2_steps)
