"""Training losses. Counterpart of `ei_nexus_tpu/losses/`: the stage-1
extractor distillation losses, the matcher losses (MNN's NLL, the
single-layer assignment NLL, LightGlue's deep-supervision loss) and the
factory that builds them from a config."""

from .extractor_loss import (descriptors_loss, feature_loss, logits_loss,
                             score_loss)
from .matcher_loss import (lightglue_loss, mnn_loss, nll_matcher_loss,
                           nll_weights_from_gt)
from .factory import build_losses

__all__ = ["score_loss", "logits_loss", "descriptors_loss", "feature_loss",
           "mnn_loss", "nll_matcher_loss", "nll_weights_from_gt",
           "lightglue_loss", "build_losses"]
