"""VGG building blocks: conv-relu-BN block, 4-stage backbone, detector and
descriptor heads.

Counterpart of `ei_nexus_tpu/models/vgg.py`, on NCHW tensors inside the
extractor (the NHWC maps of the public functions are permuted views).
Block order conv -> ReLU -> BatchNorm; 3x3 convs pad by 1 ("SAME") or not
at all ("VALID", the padding=0 cell-1 extractors). Without max pooling the
backbone keeps full resolution (the cell-1 event extractor and SiLK), and
`stage_channels` sets its per-stage widths (SiLK's ParametricVGG).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import BatchNorm, Conv2d


class VGGBlock(nn.Module):
    """Conv3x3 -> ReLU -> (BatchNorm)."""

    def __init__(self, in_channels: int, features: int,
                 use_batchnorm: bool = True,
                 dtype: torch.dtype = torch.float32, padding: str = "SAME"):
        super().__init__()
        self.conv = Conv2d(in_channels, features, 3, dtype, padding)
        self.bn = BatchNorm(features) if use_batchnorm else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.conv(x))
        return self.bn(x) if self.bn is not None else x


class VGGBackbone(nn.Module):
    """4-stage VGG encoder with widths (64,64)(64,64)(128,128)(C,C) (or
    `stage_channels`); with `use_max_pooling` a 2x2 max-pool follows each
    of the first three stages (stride 8 overall), without it the maps stay
    at full resolution."""

    def __init__(self, in_channels: int, feat_channels: int = 128,
                 use_batchnorm: bool = True,
                 dtype: torch.dtype = torch.float32,
                 use_max_pooling: bool = True,
                 stage_channels: Optional[Sequence[Tuple[int, int]]] = None,
                 padding: str = "SAME"):
        super().__init__()
        stages = stage_channels or ((64, 64), (64, 64), (128, 128),
                                    (feat_channels, feat_channels))
        self.blocks = []  # (block name, max-pool after it)
        c = in_channels
        for si, widths in enumerate(stages):
            for ci, width in enumerate(widths):
                name = f"l{si + 1}_{ci}"
                self.add_module(name, VGGBlock(c, width, use_batchnorm, dtype,
                                               padding))
                self.blocks.append((name, use_max_pooling
                                    and ci == len(widths) - 1
                                    and si < len(stages) - 1))
                c = width

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for name, pool in self.blocks:
            x = getattr(self, name)(x)
            if pool:
                x = F.max_pool2d(x, 2, 2)
        return x


class VGGDetectorHead(nn.Module):
    """VGGBlock(lat) -> Conv1x1(out) -> (BatchNorm), no final activation."""

    def __init__(self, in_channels: int, lat_channels: int = 256,
                 out_channels: int = 65, use_batchnorm: bool = True,
                 dtype: torch.dtype = torch.float32, padding: str = "SAME"):
        super().__init__()
        self.h1 = VGGBlock(in_channels, lat_channels, use_batchnorm, dtype,
                           padding)
        self.h2_conv = Conv2d(lat_channels, out_channels, 1, dtype)
        self.h2_bn = BatchNorm(out_channels) if use_batchnorm else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.h2_conv(self.h1(x))
        return self.h2_bn(x) if self.h2_bn is not None else x


class VGGDescriptorHead(VGGDetectorHead):
    """VGGBlock(out) -> Conv1x1(out) -> (BatchNorm)."""

    def __init__(self, in_channels: int, out_channels: int = 256,
                 use_batchnorm: bool = True,
                 dtype: torch.dtype = torch.float32, padding: str = "SAME"):
        super().__init__(in_channels, out_channels, out_channels,
                         use_batchnorm, dtype, padding)
