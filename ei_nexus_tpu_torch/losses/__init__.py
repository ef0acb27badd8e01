"""Training losses. Counterpart of `ei_nexus_tpu/losses/` (the matcher
losses: MNN's NLL and LightGlue's deep-supervision loss)."""

from .matcher_loss import lightglue_loss, mnn_loss, nll_weights_from_gt

__all__ = ["lightglue_loss", "mnn_loss", "nll_weights_from_gt"]
