"""SiLK-VGG image keypoint extractor (frozen teacher, cell 1).

Counterpart of `ei_nexus_tpu/models/silk.py`: SiLK's ParametricVGG
backbone (stage widths (64,64)(64,64)(128,128)(128,128), a BatchNorm after
every conv, no max pooling), a 1-channel detector head (lat 128) and a
128-d descriptor head, BatchNorm throughout; the 0-255 grayscale input is
divided by 255 inside; sigmoid probabilities, descriptor scale factor
1.41 and the full-resolution integer descriptor gather of the cell-1
postprocessing. Padding 0 ("VALID") shrinks every map by 18 px and takes
the +9 px coordinate remap.

`load_silk_state_dict` maps a SiLK checkpoint's state dict (the
reference's PyTorch layout) onto this module's names.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional

import torch
import torch.nn as nn

from .extractor import (KeypointExtractorConfig, extract_dense,
                        extract_keypoints)
from .vgg import VGGBackbone, VGGDescriptorHead, VGGDetectorHead


# SiLK's postprocessing (the JAX package's SiLKVGG default)
SILK_KEYPOINTS = KeypointExtractorConfig(
    cell_size=1, descriptor_scale_factor=1.41, sparse_desc_from="fullres",
    detection_top_k=512, smooth_mask=False)


class SiLKVGG(nn.Module):
    def __init__(self, config: KeypointExtractorConfig = SILK_KEYPOINTS,
                 feat_channels: int = 128, lat_channels: int = 128,
                 descriptor_dim: int = 128, conv_padding: str = "SAME",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.backbone = VGGBackbone(
            1, feat_channels, True, dtype, use_max_pooling=False,
            stage_channels=((64, 64), (64, 64), (128, 128),
                            (feat_channels, feat_channels)),
            padding=conv_padding)
        self.detector_head = VGGDetectorHead(feat_channels, lat_channels, 1,
                                             True, dtype, conv_padding)
        self.descriptor_head = VGGDescriptorHead(feat_channels,
                                                 descriptor_dim, True, dtype,
                                                 conv_padding)

    def _heads(self, image: torch.Tensor):
        """Backbone and heads at full resolution: the leading arguments of
        `extract_keypoints` / `extract_dense` (no padder at cell 1)."""
        assert image.ndim == 4
        H, W = image.shape[1], image.shape[2]
        x = (image.to(self.dtype) / 255.0).permute(0, 3, 1, 2)
        feats = self.backbone(x)
        logits = self.detector_head(feats)
        raw_desc = self.descriptor_head(feats)
        return (feats.permute(0, 2, 3, 1), logits.permute(0, 2, 3, 1).float(),
                raw_desc.permute(0, 2, 3, 1).float(), (H, W), None)

    def forward(self, image: torch.Tensor,
                score_mask: Optional[torch.Tensor] = None,
                dense: bool = False) -> Dict[str, Any]:
        """image: (B, H, W, 1) grayscale in [0, 255]."""
        return extract_keypoints(*self._heads(image), self.config,
                                 score_mask, dense)

    def dense_maps(self, image: torch.Tensor,
                   score_mask: Optional[torch.Tensor] = None
                   ) -> Dict[str, Any]:
        """The dense maps only (`extract_dense`): the stage-1 forward."""
        return extract_dense(*self._heads(image), self.config, score_mask)


# the reference's SiLK module names (after the flattening below) -> this
# module's
_FLATTEN = (("backbone._backbone.", "backbone."),
            ("backbone._heads._mods.logits.", "detector_head."),
            ("backbone._heads._mods.raw_descriptors.", "descriptor_head."))
_RENAMES = (
    (r"^backbone\.layers\.(\d)\.(\d)\.0\.",
     lambda m: f"backbone.l{int(m[1]) + 1}_{m[2]}.conv."),
    (r"^backbone\.layers\.(\d)\.(\d)\.2\.",
     lambda m: f"backbone.l{int(m[1]) + 1}_{m[2]}.bn."),
    (r"^(detector|descriptor)_head\._(?:det|des)H1\.0\.", r"\1_head.h1.conv."),
    (r"^(detector|descriptor)_head\._(?:det|des)H1\.2\.", r"\1_head.h1.bn."),
    (r"^(detector|descriptor)_head\._(?:det|des)H2\.0\.", r"\1_head.h2_conv."),
    (r"^(detector|descriptor)_head\._(?:det|des)H2\.1\.", r"\1_head.h2_bn."),
)
_LEAVES = ("weight", "bias", "running_mean", "running_var")


def load_silk_state_dict(state_dict: Mapping[str, Any]
                         ) -> Dict[str, torch.Tensor]:
    """A SiLK checkpoint's state dict (its lightning `_mods.model.` or
    `model.` prefix optional) -> this module's state dict (float32 CPU
    tensors), for `load_state_dict(..., strict=True)`.

    The reference's layout (SiLKVGG -> SharedBackboneMultipleHeads):
      backbone._backbone.layers.{s}.{c}.{0 conv | 2 bn}
      backbone._heads._mods.logits._detH1.{0 conv | 2 bn}, ._detH2.{0 | 1}
      backbone._heads._mods.raw_descriptors._desH1, ._desH2 likewise;
    the flat ParametricVGG names (backbone.layers..., detector_head._detH1
    ..., descriptor_head._desH1 ...) are taken too, as the JAX package's
    `load_silk_torch_weights` takes them. Both sides are PyTorch, so conv
    weights keep their OIHW layout; keys with no place here
    (`num_batches_tracked`) are dropped."""
    out: Dict[str, torch.Tensor] = {}
    for key, value in state_dict.items():
        key = re.sub(r"^(_mods\.model\.|model\.)", "", key)
        for old, new in _FLATTEN:
            key = key.replace(old, new)
        for pattern, repl in _RENAMES:
            name, n = re.subn(pattern, repl, key)
            if n and name.rsplit(".", 1)[1] in _LEAVES:
                out[name] = torch.as_tensor(value).detach().to(
                    device="cpu", dtype=torch.float32).clone()
                break
    return out
