"""SuperPoint v1 image keypoint extractor (frozen teacher).

Counterpart of `ei_nexus_tpu/models/superpoint.py`: conv encoder
(64,64)-pool-(64,64)-pool-(128,128)-pool-(128,128) with ReLU and no
batchnorm; detector head convPa(256, 3x3) -> convPb(65, 1x1); descriptor
head convDa(256, 3x3) -> convDb(D, 1x1); the 0-255 grayscale input is
divided by 255 inside; postprocessing shared with the event extractor,
with the event mask applied unsmoothed.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import Padder
from .extractor import (KeypointExtractorConfig, extract_dense,
                        extract_keypoints)
from .layers import Conv2d

# (name, in, out, kernel, max-pool after)
_ENCODER = (("conv1a", 1, 64, 3, False), ("conv1b", 64, 64, 3, True),
            ("conv2a", 64, 64, 3, False), ("conv2b", 64, 64, 3, True),
            ("conv3a", 64, 128, 3, False), ("conv3b", 128, 128, 3, True),
            ("conv4a", 128, 128, 3, False), ("conv4b", 128, 128, 3, False))


class SuperPointV1(nn.Module):
    def __init__(self, config: KeypointExtractorConfig = KeypointExtractorConfig(),
                 descriptor_dim: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        self.dtype = dtype
        for name, cin, cout, k, _ in _ENCODER:
            self.add_module(name, Conv2d(cin, cout, k, dtype))
        self.convPa = Conv2d(128, 256, 3, dtype)
        self.convPb = Conv2d(256, 65, 1, dtype)
        self.convDa = Conv2d(128, 256, 3, dtype)
        self.convDb = Conv2d(256, descriptor_dim, 1, dtype)

    def _heads(self, image: torch.Tensor):
        """Encoder and heads on the padded image: the leading arguments of
        `extract_keypoints` / `extract_dense`."""
        assert image.ndim == 4
        H, W = image.shape[1], image.shape[2]
        x = image.to(self.dtype) / 255.0
        if x.shape[-1] == 3:
            # ITU-R 601 luma, matching kornia rgb_to_grayscale
            x = (0.299 * x[..., 0:1] + 0.587 * x[..., 1:2]
                 + 0.114 * x[..., 2:3])
        padder = Padder(H, W, 8)
        x = padder.pad(x).permute(0, 3, 1, 2)    # NCHW view, channels-last
        for name, _, _, _, pool in _ENCODER:
            x = F.relu(getattr(self, name)(x))
            if pool:
                x = F.max_pool2d(x, 2, 2)
        feats = x
        logits = self.convPb(F.relu(self.convPa(feats)))
        raw_desc = self.convDb(F.relu(self.convDa(feats)))
        return (feats.permute(0, 2, 3, 1), logits.permute(0, 2, 3, 1).float(),
                raw_desc.permute(0, 2, 3, 1).float(), (H, W), padder)

    def _postprocessing(self) -> KeypointExtractorConfig:
        # the event mask applies unsmoothed on the image side
        return dataclasses.replace(self.config, smooth_mask=False)

    def forward(self, image: torch.Tensor,
                score_mask: Optional[torch.Tensor] = None,
                dense: bool = False) -> Dict[str, Any]:
        """image: (B, H, W, 1) grayscale in [0, 255] (or (B, H, W, 3) RGB)."""
        return extract_keypoints(*self._heads(image), self._postprocessing(),
                                 score_mask, dense)

    def dense_maps(self, image: torch.Tensor,
                   score_mask: Optional[torch.Tensor] = None
                   ) -> Dict[str, Any]:
        """The dense maps only (`extract_dense`): the stage-1 forward."""
        return extract_dense(*self._heads(image), self._postprocessing(),
                             score_mask)
