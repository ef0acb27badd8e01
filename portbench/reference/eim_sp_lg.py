"""The plain reference of `eim_sp_lg` (configs/eim_sp_lg.json): EI-Nexus
with the cell-8 event VGG, the frozen SuperPoint v1 and LightGlue, as
`reference.eim` wires `reference.nets`."""

from portbench.reference.eim import (extract_pair, match,  # noqa: F401
                                     representation, stage2_steps)
