"""Composite model: EIM (event-image matching).

Counterpart of `ei_nexus_tpu/models/eim.py`: an event extractor, a frozen
image extractor and the Matcher wrapper, dispatched from the same config
dataclasses. At inference the Matcher fits the fixed-K slots to
`max_points_num` and the validity masks flow into the matcher.

In training, as the JAX package's per-call `train` flags do, each forward
puts every extractor in train() or eval() mode: a trainable extractor
(stage 1) runs with its BatchNorm on batch statistics, updating the
running ones, and a frozen one runs as at inference, BatchNorm on its
running statistics and without gradient.
 - Stage 1 (an extractor trainable): the forward returns both extractors'
   dense maps (`dense_maps`: what the distillation losses read) and no
   matches. The compiled JAX step computes no more: nothing it reads
   depends on the keypoints, so XLA drops the NMS, the top-k and the
   matcher.
 - Stage 2 (both extractors frozen, the matcher trained): with
   pad_mode="random" the Matcher fills the invalid slots with random
   keypoints, after which every slot is valid.

`ImageImageMatcher` runs one shared image extractor on two frames and
the same Matcher.

Every extractor of the JAX package is ported: the event extractors "vgg"
(cell 8) and "vgg_np" (cell 1), the image extractors "superpointv1" and
"silk" (cell 1), the last two at padding 1 or 0 (VALID convolutions and
the +9 px remap); and the LightGlue and MNN matchers.
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
from .silk import SiLKVGG
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

    type: str = "vgg"                    # vgg | vgg_np | superpointv1 | silk
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
    """The extractor of `spec`, as the JAX package's `_build_extractor`
    builds it: "vgg" ignores `padding` (SAME convolutions always); the
    cell-1 types take padding 0 as VALID convolutions and the +9 px
    remap; "silk" has SiLK's own widths and scale factor 1.41, whatever
    the spec says."""
    kcfg = spec.keypoints
    dtype = getattr(torch, spec.dtype)
    padding = "VALID" if spec.padding == 0 else "SAME"
    offset = 9.0 if spec.padding == 0 else 0.0
    if spec.type == "vgg":
        return VGGExtractor(
            config=kcfg, in_channels=spec.in_channels,
            feat_channels=spec.feat_channels,
            descriptor_dim=spec.descriptor_dim,
            lat_channels=spec.lat_channels,
            use_batchnorm=spec.use_batchnorm, dtype=dtype)
    if spec.type == "vgg_np":
        kcfg = dataclasses.replace(kcfg, cell_size=1,
                                   sparse_desc_from="fullres",
                                   coord_offset=offset)
        return VGGExtractor(
            config=kcfg, in_channels=spec.in_channels,
            feat_channels=spec.feat_channels,
            descriptor_dim=spec.descriptor_dim,
            lat_channels=spec.lat_channels,
            use_batchnorm=spec.use_batchnorm, dtype=dtype,
            use_max_pooling=False, conv_padding=padding)
    if spec.type == "superpointv1":
        return SuperPointV1(config=kcfg,
                            descriptor_dim=spec.descriptor_dim, dtype=dtype)
    if spec.type == "silk":
        kcfg = dataclasses.replace(kcfg, cell_size=1,
                                   sparse_desc_from="fullres",
                                   descriptor_scale_factor=1.41,
                                   coord_offset=offset)
        return SiLKVGG(config=kcfg, conv_padding=padding, dtype=dtype)
    raise ValueError(f"unknown extractor type {spec.type!r}")


Fill = Tuple[torch.Tensor, torch.Tensor]


def run_extractor(extractor: nn.Module, train: bool, x: torch.Tensor,
                  mask: Optional[torch.Tensor], dense: bool = False,
                  stage1: bool = False) -> Dict[str, torch.Tensor]:
    """One extractor in train() (`train`: batch statistics, gradients) or
    eval() mode (running statistics, no gradient): its dense maps when
    `stage1`, else its keypoints."""
    extractor.train(train)
    with torch.set_grad_enabled(torch.is_grad_enabled() and train):
        if stage1:
            return extractor.dense_maps(x, mask)
        return extractor(x, mask, dense)


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
        `training=True` trains what is not frozen: with a trainable
        extractor (stage 1) both extractors' dense maps come back and the
        matches are None; else the matcher trains, `generator` and `fill`
        driving its random slot fill (Matcher)."""
        cfg = self.config
        ev_train = training and not cfg.event_extractor.freeze
        im_train = training and not cfg.image_extractor.freeze
        stage1 = ev_train or im_train
        events_feats = run_extractor(self.event_extractor, ev_train, events,
                                     events_mask, dense, stage1)
        image_feats = run_extractor(self.image_extractor, im_train, image,
                                    image_mask, dense, stage1)
        if stage1:
            return events_feats, image_feats, None
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
                training: bool = False, dense: bool = False
                ) -> Tuple[Dict, Dict, Optional[Dict]]:
        """image0, image1: (B, H, W, 1) in [0, 255]; `training` and `dense`
        as `EIM.forward` (the random fill from torch's default generator):
        a trainable extractor gives both frames' dense maps, in train()
        mode one after the other, and no matches."""
        cfg = self.config
        train = training and not cfg.image_extractor.freeze
        feats0 = run_extractor(self.image_extractor, train, image0, mask0,
                               dense, stage1=train)
        feats1 = run_extractor(self.image_extractor, train, image1, mask1,
                               dense, stage1=train)
        if train:
            return feats0, feats1, None
        matches = self.matcher(feats0, feats1,
                               training=training and not cfg.matcher.freeze)
        return feats0, feats1, matches


def build_model(model_type: str, config: EIMConfig,
                device: Optional[Union[str, torch.device]] = None,
                training_heads: bool = False) -> nn.Module:
    """Name -> module dispatch ("EDM" is accepted as EIM, like the JAX
    package; "ImageImageMatcher"), in eval mode on `device` (the card
    unless the caller names another); `training_heads` gives LightGlue
    every layer's assignment and confidence heads (stage-2 training)."""
    dev = resolve_device(device)
    if model_type in ("EIM", "EDM"):
        model = EIM(config, training_heads)
    elif model_type == "ImageImageMatcher":
        model = ImageImageMatcher(config, training_heads)
    else:
        raise ValueError(f"unknown model type {model_type!r}")
    return model.to(dev).eval()
