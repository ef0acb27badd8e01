"""Training losses. Counterpart of `ei_nexus_tpu/losses/` (the LightGlue
deep-supervision loss of stage 2 so far)."""

from .matcher_loss import lightglue_loss, nll_weights_from_gt

__all__ = ["lightglue_loss", "nll_weights_from_gt"]
