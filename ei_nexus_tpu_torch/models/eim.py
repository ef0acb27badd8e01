"""Composite model: EIM (event-image matching).

Counterpart of `ei_nexus_tpu/models/eim.py`: an event extractor, a frozen
image extractor and the Matcher wrapper, dispatched from the same config
dataclasses. At inference the Matcher fits the fixed-K slots to
`max_points_num` and the validity masks flow into the matcher. In training
(stage 2: both extractors frozen, the matcher trained) the extractors run
as at inference, BatchNorm on its running statistics and without
gradient, and with pad_mode="random" the Matcher fills the invalid slots
with random keypoints, after which every slot is valid.

`ImageImageMatcher` runs one shared image extractor on two frames and
the same Matcher.

Ported so far: the "vgg" event extractor, the "superpointv1" image
extractor and the LightGlue and MNN matchers. Other extractor and matcher
types and training an extractor (stage 1) raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..device import resolve_device
from .extractor import KeypointExtractorConfig, VGGExtractor
from .lightglue import LightGlue, LightGlueConfig
from .mnn import mnn_match
from .superpoint import SuperPointV1


@dataclasses.dataclass(frozen=True)
class MatcherConfig:
    type: Optional[str] = "MNN"          # "MNN" | "LightGlue" | None
    freeze: bool = True
    max_points_num: int = 1024
    pad_mode: str = "random"             # "random" | "zeros" | "mask"
    desc_scale_factor: float = 1.0
    ratio_thresh: Optional[float] = None
    distance_thresh: Optional[float] = None
    lightglue: LightGlueConfig = LightGlueConfig()


@dataclasses.dataclass(frozen=True)
class ExtractorSpec:
    """One extractor's type + hyperparameters."""

    type: str = "vgg"                    # vgg | superpointv1 (others later)
    freeze: bool = False
    dtype: str = "float32"               # conv compute dtype
    in_channels: int = 16
    feat_channels: int = 128
    descriptor_dim: int = 256
    lat_channels: int = 256
    use_batchnorm: bool = True
    padding: int = 1
    keypoints: KeypointExtractorConfig = KeypointExtractorConfig()


@dataclasses.dataclass(frozen=True)
class EIMConfig:
    event_extractor: ExtractorSpec = ExtractorSpec(type="vgg")
    image_extractor: ExtractorSpec = ExtractorSpec(
        type="superpointv1", freeze=True)
    matcher: MatcherConfig = MatcherConfig()


def _build_extractor(spec: ExtractorSpec) -> nn.Module:
    dtype = getattr(torch, spec.dtype)
    if spec.type == "vgg":
        if spec.padding != 1:
            raise NotImplementedError("only padding=1 VGG is ported")
        return VGGExtractor(
            config=spec.keypoints, in_channels=spec.in_channels,
            feat_channels=spec.feat_channels,
            descriptor_dim=spec.descriptor_dim,
            lat_channels=spec.lat_channels,
            use_batchnorm=spec.use_batchnorm, dtype=dtype)
    if spec.type == "superpointv1":
        return SuperPointV1(config=spec.keypoints,
                            descriptor_dim=spec.descriptor_dim, dtype=dtype)
    raise NotImplementedError(f"extractor type {spec.type!r} is not ported")


Fill = Tuple[torch.Tensor, torch.Tensor]


def random_fill(feats: Dict[str, torch.Tensor], length: int,
                scale: float = 1.0,
                generator: Optional[torch.Generator] = None) -> Fill:
    """The random keypoints of the training fill, one per slot: positions
    (B, length, 3), uniform over the image (`image_size`, (H, W)) with a
    zero third column; descriptors (B, length, D), normal, L2-normalised,
    times `scale`. Drawn on the features' device from `generator` (a
    generator of that device; torch's default when None), positions
    first."""
    pos = feats["sparse_positions"]
    desc = feats["sparse_descriptors"]
    B, D = pos.shape[0], desc.shape[-1]
    u = torch.rand(B, length, 2, generator=generator, dtype=pos.dtype,
                   device=pos.device)
    yx = u * feats["image_size"][:, None, :].to(pos.dtype)
    rand_pos = torch.cat([yx, yx.new_zeros(B, length, 1)], dim=-1)
    n = torch.randn(B, length, D, generator=generator, dtype=desc.dtype,
                    device=desc.device)
    n = n / n.norm(dim=-1, keepdim=True).clamp(min=1e-12)
    return rand_pos, n * scale


class Matcher(nn.Module):
    """Matcher wrapper: slot fitting + type dispatch."""

    def __init__(self, config: MatcherConfig = MatcherConfig(),
                 training_heads: bool = False):
        super().__init__()
        self.config = config
        if config.type == "LightGlue":
            self.lightglue = LightGlue(config.lightglue, training_heads)
        elif config.type not in ("MNN", None):
            raise NotImplementedError(
                f"matcher type {config.type!r} is not ported")

    def _fit_slots(self, feats: Dict[str, torch.Tensor],
                   fill: Optional[Fill] = None) -> Dict[str, torch.Tensor]:
        """Truncate or zero-pad the fixed-K slots to max_points_num. Without
        `fill` (the eval path) invalid slots stay invalid and are masked
        downstream; with fill = (positions, descriptors) for every slot,
        invalid slots take the fill and all slots become valid."""
        L = self.config.max_points_num
        pos = feats["sparse_positions"]
        desc = feats["sparse_descriptors"]
        valid = feats.get("sparse_valid")
        if valid is None:
            valid = torch.ones(pos.shape[:2], dtype=torch.bool,
                               device=pos.device)
        K = pos.shape[1]
        if K >= L:
            pos, desc, valid = pos[:, :L], desc[:, :L], valid[:, :L]
        else:
            pos = F.pad(pos, (0, 0, 0, L - K))
            desc = F.pad(desc, (0, 0, 0, L - K))
            valid = F.pad(valid, (0, L - K))
        if fill is not None:
            m = valid[..., None]
            pos = torch.where(m, pos, fill[0].to(pos.dtype))
            desc = torch.where(m, desc, fill[1].to(desc.dtype))
            valid = torch.ones_like(valid)
        out = dict(feats)
        out["sparse_positions"] = pos
        out["sparse_descriptors"] = desc
        out["sparse_valid"] = valid
        return out

    def forward(self, feats0: Dict[str, torch.Tensor],
                feats1: Dict[str, torch.Tensor],
                training: bool = False,
                generator: Optional[torch.Generator] = None,
                fill: Optional[Tuple[Fill, Fill]] = None
                ) -> Optional[Dict[str, torch.Tensor]]:
        """In training with pad_mode="random" the invalid slots are filled:
        from `fill` = (fill0, fill1) when given (each as `random_fill`
        returns it), else drawn with `random_fill` from `generator`, side 0
        first. The filled slots come back in input_feats0/1."""
        cfg = self.config
        if cfg.type is None:
            return None
        if not (training and cfg.pad_mode == "random"):
            fill = (None, None)
        elif fill is None:
            fill = tuple(random_fill(f, cfg.max_points_num,
                                     cfg.desc_scale_factor, generator)
                         for f in (feats0, feats1))
        f0 = self._fit_slots(feats0, fill[0])
        f1 = self._fit_slots(feats1, fill[1])
        if cfg.type == "MNN":
            out = mnn_match(f0, f1, cfg.ratio_thresh, cfg.distance_thresh,
                            mutual_check=True)
        else:
            out = self.lightglue(f0, f1, training=training)
        keys = ("sparse_positions", "sparse_descriptors", "sparse_valid",
                "image_size")
        out["input_feats0"] = {k: f0[k] for k in keys}
        out["input_feats1"] = {k: f1[k] for k in keys}
        return out


class EIM(nn.Module):
    """Event extractor + (frozen) image extractor + matcher."""

    def __init__(self, config: EIMConfig = EIMConfig(),
                 training_heads: bool = False):
        super().__init__()
        self.config = config
        self.event_extractor = _build_extractor(config.event_extractor)
        self.image_extractor = _build_extractor(config.image_extractor)
        self.matcher = Matcher(config.matcher, training_heads)

    def forward(self, events: torch.Tensor, image: torch.Tensor,
                events_mask: Optional[torch.Tensor] = None,
                image_mask: Optional[torch.Tensor] = None,
                training: bool = False, dense: bool = False,
                generator: Optional[torch.Generator] = None,
                fill=None) -> Tuple[Dict, Dict, Optional[Dict]]:
        """events: (B, H, W, bins) NHWC; image: (B, H, W, 1) in [0, 255];
        events_mask: (B, H, W) bool occupancy. `dense=True` also returns
        the full-resolution descriptor maps (see models/extractor.py).
        `training=True` trains the matcher unless it is frozen;
        `generator` and `fill` drive its random slot fill (Matcher)."""
        cfg = self.config
        if training and not (cfg.event_extractor.freeze
                             and cfg.image_extractor.freeze):
            raise NotImplementedError(
                "training an extractor (stage 1) is not ported yet")
        # frozen extractors run as at inference (JAX's train=False): BN on
        # its running statistics, and nothing to differentiate
        with torch.set_grad_enabled(torch.is_grad_enabled() and not training):
            events_feats = self.event_extractor(events, events_mask, dense)
            image_feats = self.image_extractor(image, image_mask, dense)
        matches = self.matcher(events_feats, image_feats,
                               training=training and not cfg.matcher.freeze,
                               generator=generator, fill=fill)
        return events_feats, image_feats, matches


class ImageImageMatcher(nn.Module):
    """Two frames through one shared image extractor, then the matcher
    (the SuperPoint/SiLK baseline of the JAX package)."""

    def __init__(self, config: EIMConfig = EIMConfig(),
                 training_heads: bool = False):
        super().__init__()
        self.config = config
        self.image_extractor = _build_extractor(config.image_extractor)
        self.matcher = Matcher(config.matcher, training_heads)

    def forward(self, image0: torch.Tensor, image1: torch.Tensor,
                mask0: Optional[torch.Tensor] = None,
                mask1: Optional[torch.Tensor] = None,
                training: bool = False) -> Tuple[Dict, Dict, Optional[Dict]]:
        """image0, image1: (B, H, W, 1) in [0, 255]; `training` as
        `EIM.forward` (the random fill from torch's default generator)."""
        cfg = self.config
        if training and not cfg.image_extractor.freeze:
            raise NotImplementedError(
                "training an extractor (stage 1) is not ported yet")
        with torch.set_grad_enabled(torch.is_grad_enabled() and not training):
            feats0 = self.image_extractor(image0, mask0)
            feats1 = self.image_extractor(image1, mask1)
        matches = self.matcher(feats0, feats1,
                               training=training and not cfg.matcher.freeze)
        return feats0, feats1, matches


def build_model(model_type: str, config: EIMConfig,
                device: Optional[Union[str, torch.device]] = None
                ) -> nn.Module:
    """Name -> module dispatch ("EDM" is accepted as EIM, like the JAX
    package; "ImageImageMatcher"), in eval mode on `device` (the card
    unless the caller names another)."""
    dev = resolve_device(device)
    if model_type in ("EIM", "EDM"):
        model = EIM(config=config)
    elif model_type == "ImageImageMatcher":
        model = ImageImageMatcher(config=config)
    else:
        raise ValueError(f"unknown model type {model_type!r}")
    return model.to(dev).eval()
