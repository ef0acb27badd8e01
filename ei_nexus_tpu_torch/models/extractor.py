"""Keypoint extractor: VGG backbone + heads + fixed-K postprocessing.

Counterpart of `ei_nexus_tpu/models/extractor.py`: the cell-8 event
extractor (max pooling, 65-channel detector) and the cell-1 one
(`use_max_pooling=False`: full resolution, a 1-channel sigmoid detector,
the full-resolution integer descriptor gather; with padding 0 the VALID
convolutions shrink every map by 18 px and positions take the +9 px
remap of `coord_offset`). Output contract (NHWC maps, fixed K slots):
  sparse_positions   (B, K, 3)  (y+0.5, x+0.5, prob), score-sorted
  sparse_valid       (B, K)     slot validity (threshold rule + in-image)
  sparse_descriptors (B, K, D)
plus the dense maps. Eager PyTorch computes every map it is asked for
(there is no compiler to drop unread outputs), so the full-resolution
descriptor maps `normalized_descriptors`, `dense_descriptors` and
`dense_positions` (~760 MB per cell-8 extractor at the flagship size) are
made only when the caller passes `dense=True`; the inference path does
not. At cell 1 `normalized_descriptors` is the coarse map itself.
`extract_dense` (an extractor's `dense_maps`) is the stage-1 forward: the
dense maps the distillation losses read, `normalized_descriptors`
included, and no keypoint selection.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn as nn

from ..ops import (
    Padder, logits_to_prob, depth_to_space, remove_border_scores, nms,
    select_topk_keypoints, smooth_score_mask, normalize_descriptors,
    sample_descriptors_lowres, sample_descriptors_fullres,
    upsample_descriptors, dense_descriptors, dense_positions,
)
from ..utils.profiling import annotate
from .vgg import VGGBackbone, VGGDetectorHead, VGGDescriptorHead


@dataclasses.dataclass(frozen=True)
class KeypointExtractorConfig:
    """Static postprocessing configuration."""

    cell_size: int = 8
    nms_radius: int = 4
    detection_top_k: int = 1024
    detection_threshold: float = 1.0
    remove_borders: int = 4
    ordering: str = "yx"
    descriptor_scale_factor: float = 1.0
    smooth_mask: bool = True          # 3x3-dilate the event mask before use
    coord_offset: float = 0.0         # +9.0 for the padding=0 NP variant
    sparse_desc_from: str = "lowres"  # "lowres" (cell 8) | "fullres" (cell 1)
    nms_impl: str = "auto"            # "auto" | "xla" | "pallas"


def _score_maps(logits: torch.Tensor, padder: Optional[Padder],
                cfg: KeypointExtractorConfig,
                score_mask: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(probability, border-zeroed score on the padded grid): probability
    -> pixel-shuffle score -> event mask -> border removal. The
    border-zeroed map is what the reference returns as `score` (its
    remove_border_points zeroes the tensor in place). At cell 1 the
    reference's pixel shuffle and squeeze are views, so the same in-place
    zeroing reaches its `probability`: it is the masked, border-zeroed
    score, as in the JAX package."""
    probability = logits_to_prob(logits)     # (B, hp, wp, cell^2+1 | 1)
    score = depth_to_space(probability, cfg.cell_size)     # (B, Hp, Wp)
    if score_mask is not None:
        mask = score_mask[..., 0] if score_mask.ndim == 4 else score_mask
        if padder is not None:
            mask = padder.pad(mask, hw_axes=(-2, -1))
        if cfg.smooth_mask:
            mask = smooth_score_mask(mask)
        score = torch.where(mask, score, torch.zeros_like(score))
    bordered = remove_border_scores(score, cfg.remove_borders)
    if cfg.cell_size == 1:
        probability = bordered[..., None]
    return probability, bordered


def _normalized_descriptors(raw_desc: torch.Tensor, coarse: torch.Tensor,
                            padded_size: Tuple[int, int],
                            padder: Optional[Padder],
                            cfg: KeypointExtractorConfig) -> torch.Tensor:
    """The full-resolution L2-normalised descriptor map, unpadded: the
    coarse map upsampled at cell 8, the coarse map itself at cell 1."""
    if cfg.cell_size == 1:
        return coarse
    normalized = upsample_descriptors(raw_desc, padded_size,
                                      cfg.descriptor_scale_factor)
    return padder.unpad(normalized) if padder is not None else normalized


def _shift(positions: torch.Tensor, offset: float) -> torch.Tensor:
    """(y, x, ...) positions + the padding=0 coordinate remap."""
    if not offset:
        return positions
    return torch.cat([positions[..., :2] + offset, positions[..., 2:]],
                     dim=-1)


def _image_size(B: int, image_size: Tuple[int, int],
                device: torch.device) -> torch.Tensor:
    H, W = image_size
    return torch.stack([torch.full((B,), float(H), device=device),
                        torch.full((B,), float(W), device=device)], dim=-1)


def extract_dense(
    feats: torch.Tensor,
    logits: torch.Tensor,
    raw_desc: torch.Tensor,
    image_size: Tuple[int, int],
    padder: Optional[Padder],
    cfg: KeypointExtractorConfig,
    score_mask: Optional[torch.Tensor] = None,
) -> Dict[str, Any]:
    """The dense maps of `extract_keypoints` and nothing else: image_size,
    backbone_feats, logits, raw_descriptors, probability, score (border-
    zeroed, unpadded), coarse_descriptors and normalized_descriptors
    (unpadded). These are all the stage-1 losses read, and all the
    compiled JAX stage-1 step computes: it reads no keypoint, so XLA drops
    the NMS, the top-k and the descriptor sampling. Here they are not run
    at all, and the maps keep their autograd graph."""
    B = logits.shape[0]
    padded_size = (logits.shape[1] * cfg.cell_size,
                   logits.shape[2] * cfg.cell_size)
    probability, bordered = _score_maps(logits, padder, cfg, score_mask)
    coarse = normalize_descriptors(raw_desc, cfg.descriptor_scale_factor)
    return {
        "image_size": _image_size(B, image_size, logits.device),
        "backbone_feats": feats,
        "logits": logits,
        "raw_descriptors": raw_desc,
        "probability": probability,
        "score": (padder.unpad(bordered, hw_axes=(-2, -1))
                  if padder is not None else bordered),
        "coarse_descriptors": coarse,
        "normalized_descriptors": _normalized_descriptors(
            raw_desc, coarse, padded_size, padder, cfg),
    }


def extract_keypoints(
    feats: torch.Tensor,
    logits: torch.Tensor,
    raw_desc: torch.Tensor,
    image_size: Tuple[int, int],
    padder: Optional[Padder],
    cfg: KeypointExtractorConfig,
    score_mask: Optional[torch.Tensor] = None,
    dense: bool = False,
) -> Dict[str, Any]:
    """Turn head outputs into the feature dict.

    feats/logits/raw_desc are NHWC maps on the *padded* grid (the score
    grid itself at cell 1, which has no padder); `image_size` is the
    original (H, W). Pipeline order: probability -> pixel-shuffle score ->
    event mask -> border removal -> NMS -> top-k threshold -> descriptor
    sampling -> unpad & in-image filtering -> the `coord_offset` remap.
    Keypoint selection carries no gradient (the JAX package's
    stop_gradient around the NMS): the NMS reads a detached score map, so
    the kept map and the positions' scores are constants."""
    H, W = image_size
    B = logits.shape[0]
    padded_size = (logits.shape[1] * cfg.cell_size,
                   logits.shape[2] * cfg.cell_size)
    probability, bordered = _score_maps(logits, padder, cfg, score_mask)
    with annotate("ei.extract.nms"):
        nms_map = nms(bordered.detach(), cfg.nms_radius, impl=cfg.nms_impl)
    # after nms(radius=r) survivors are > r apart, so top-k may first
    # reduce to per-(r+1)-block candidates
    with annotate("ei.extract.topk"):
        positions, valid = select_topk_keypoints(
            nms_map, cfg.detection_top_k, cfg.detection_threshold,
            cfg.ordering, min_distance=cfg.nms_radius + 1)

    with annotate("ei.extract.describe"):
        if cfg.sparse_desc_from == "lowres":
            sparse_desc = sample_descriptors_lowres(
                raw_desc, positions, padded_size,
                cfg.descriptor_scale_factor, True, cfg.ordering)
        else:
            sparse_desc = sample_descriptors_fullres(
                raw_desc, positions, cfg.descriptor_scale_factor, True,
                cfg.ordering)
        coarse = normalize_descriptors(raw_desc, cfg.descriptor_scale_factor)

    if padder is not None:
        score_u = padder.unpad(bordered, hw_axes=(-2, -1))
        positions = padder.unpad_positions(positions, cfg.ordering)
    else:
        score_u = bordered

    if cfg.ordering == "yx":
        py, px = positions[..., 0], positions[..., 1]
    else:
        px, py = positions[..., 0], positions[..., 1]
    valid = valid & (py >= 0) & (py < H) & (px >= 0) & (px < W)
    positions = _shift(positions, cfg.coord_offset)

    # thresholded dense NMS map: only the selected keypoints' scores, in
    # score-map coordinates (the offset taken off again, as the JAX
    # package takes it)
    Hs, Ws = score_u.shape[1], score_u.shape[2]
    cy, cx = (0, 1) if cfg.ordering == "yx" else (1, 0)
    iy = torch.floor(positions[..., cy] - cfg.coord_offset).to(torch.int64)
    ix = torch.floor(positions[..., cx] - cfg.coord_offset).to(torch.int64)
    kept = torch.zeros(B, Hs * Ws, dtype=score_u.dtype, device=logits.device)
    kept.scatter_add_(1, iy.clamp(0, Hs - 1) * Ws + ix.clamp(0, Ws - 1),
                      torch.where(valid, positions[..., 2],
                                  torch.zeros_like(positions[..., 2])))

    out = {
        "image_size": _image_size(B, image_size, logits.device),
        "backbone_feats": feats,
        "logits": logits,
        "raw_descriptors": raw_desc,
        "probability": probability,
        "score": score_u,
        "nms": kept.reshape(B, Hs, Ws),
        "coarse_descriptors": coarse,
        "sparse_positions": positions,
        "sparse_valid": valid,
        "sparse_descriptors": sparse_desc,
    }
    if dense:
        normalized = _normalized_descriptors(raw_desc, coarse, padded_size,
                                             padder, cfg)
        out["normalized_descriptors"] = normalized
        out["dense_descriptors"] = dense_descriptors(normalized)
        out["dense_positions"] = _shift(dense_positions(score_u,
                                                        cfg.ordering),
                                        cfg.coord_offset)
    return out


class VGGExtractor(nn.Module):
    """Event keypoint extractor (VGG backbone + detector and descriptor
    heads + postprocessing). Input (B, H, W, C) NHWC. `use_max_pooling`
    gives cell 8 (a 65-channel detector, the map padded to a multiple of
    8); without it, cell 1 (a 1-channel detector at full resolution, no
    padder). `conv_padding="VALID"` is the padding=0 variant, which takes
    no score mask (the JAX package asserts as much)."""

    def __init__(self, config: KeypointExtractorConfig = KeypointExtractorConfig(),
                 in_channels: int = 16, feat_channels: int = 128,
                 descriptor_dim: int = 256, lat_channels: int = 256,
                 use_batchnorm: bool = True,
                 dtype: torch.dtype = torch.float32,
                 use_max_pooling: bool = True, conv_padding: str = "SAME"):
        super().__init__()
        self.config = config
        self.cell = 8 if use_max_pooling else 1
        self.conv_padding = conv_padding
        self.backbone = VGGBackbone(in_channels, feat_channels, use_batchnorm,
                                    dtype, use_max_pooling,
                                    padding=conv_padding)
        self.detector_head = VGGDetectorHead(
            feat_channels, lat_channels, 65 if self.cell > 1 else 1,
            use_batchnorm, dtype, conv_padding)
        self.descriptor_head = VGGDescriptorHead(
            feat_channels, descriptor_dim, use_batchnorm, dtype,
            conv_padding)

    def _heads(self, x: torch.Tensor, score_mask: Optional[torch.Tensor]):
        """Backbone and heads on the padded input: the leading arguments of
        `extract_keypoints` / `extract_dense`."""
        assert x.ndim == 4, "expected NHWC input"
        if self.conv_padding == "VALID" and score_mask is not None:
            raise ValueError("score_mask unsupported with VALID conv "
                             "padding")
        H, W = x.shape[1], x.shape[2]
        padder = Padder(H, W, 8) if self.cell > 1 else None
        if padder is not None:
            x = padder.pad(x)
        x = x.permute(0, 3, 1, 2)    # NCHW view, channels-last
        feats = self.backbone(x)
        logits = self.detector_head(feats)
        raw_desc = self.descriptor_head(feats)
        return (feats.permute(0, 2, 3, 1), logits.permute(0, 2, 3, 1).float(),
                raw_desc.permute(0, 2, 3, 1).float(), (H, W), padder)

    def forward(self, x: torch.Tensor,
                score_mask: Optional[torch.Tensor] = None,
                dense: bool = False) -> Dict[str, Any]:
        return extract_keypoints(*self._heads(x, score_mask), self.config,
                                 score_mask, dense)

    def dense_maps(self, x: torch.Tensor,
                   score_mask: Optional[torch.Tensor] = None
                   ) -> Dict[str, Any]:
        """The dense maps only (`extract_dense`): the stage-1 forward."""
        return extract_dense(*self._heads(x, score_mask), self.config,
                             score_mask)
