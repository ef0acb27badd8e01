"""Loss factory: the {keypoints, descriptors, feature, matcher} loss
callables from a training config's `loss` section.

Counterpart of `ei_nexus_tpu/losses/factory.py`, with its no-op default:
a loss the config does not name returns (0, {}).
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Mapping

import torch

from .extractor_loss import (descriptors_loss, feature_loss, logits_loss,
                             score_loss)
from .matcher_loss import mnn_loss, nll_matcher_loss


def _passthrough(*args, **kwargs):
    return torch.zeros(()), {}


def build_losses(config: Mapping[str, Any]) -> Dict[str, Callable]:
    """config mirrors the training config's `loss` group:
    keypoints_loss.type in {ScoreLoss, LogitsLoss}, descriptors_loss.type
    DescriptorsLoss, feature_loss.type FeatureLoss, matcher_loss.type in
    {MNNLoss, NLLLoss}; each with its own kwargs sub-dict."""
    out: Dict[str, Callable] = {
        "keypoints_loss": _passthrough,
        "descriptors_loss": _passthrough,
        "feature_loss": _passthrough,
        "matcher_loss": _passthrough,
    }

    kp = config.get("keypoints_loss", {})
    if kp.get("type") == "ScoreLoss":
        p = kp.get("ScoreLoss", {})
        out["keypoints_loss"] = functools.partial(
            score_loss, mode=p.get("mode", "mse"),
            weight=p.get("weight", 1.0), use_mask=p.get("use_mask", True))
    elif kp.get("type") == "LogitsLoss":
        p = kp.get("LogitsLoss", {})
        out["keypoints_loss"] = functools.partial(
            logits_loss, cell_size=p.get("cell_size", 8),
            weight=p.get("weight", 1.0))

    de = config.get("descriptors_loss", {})
    if de.get("type") == "DescriptorsLoss":
        p = dict(de.get("DescriptorsLoss", {}))
        extra = p.pop("mae+triplet", {})
        out["descriptors_loss"] = functools.partial(
            descriptors_loss, mode=p.get("mode", "mae"),
            desc_type=p.get("desc_type", "normalized"),
            weight=p.get("weight", 1.0), use_mask=p.get("use_mask", True),
            mae_weight=extra.get("mae_weight", 1.0),
            triplet_weight=extra.get("triplet_weight", 100.0))

    fe = config.get("feature_loss", {})
    if fe.get("type") == "FeatureLoss":
        p = fe.get("FeatureLoss", {})
        out["feature_loss"] = functools.partial(
            feature_loss, mode=p.get("mode", "mse"),
            weight=p.get("weight", 1.0))

    ma = config.get("matcher_loss", {})
    if ma.get("type") == "MNNLoss":
        p = ma.get("MNNLoss", {})
        out["matcher_loss"] = functools.partial(
            mnn_loss, weight=p.get("weight", 1.0))
    elif ma.get("type") == "NLLLoss":
        p = ma.get("NLLLoss", {})
        out["matcher_loss"] = functools.partial(
            nll_matcher_loss, weight=p.get("weight", 1.0),
            nll_balancing=p.get("nll_balancing", 0.5))

    return out
