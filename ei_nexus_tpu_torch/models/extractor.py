"""Keypoint extractor: VGG backbone + heads + fixed-K postprocessing.

Counterpart of `ei_nexus_tpu/models/extractor.py` for the cell-8 event
extractor. Output contract (NHWC maps, fixed K slots):
  sparse_positions   (B, K, 3)  (y+0.5, x+0.5, prob), score-sorted
  sparse_valid       (B, K)     slot validity (threshold rule + in-image)
  sparse_descriptors (B, K, D)
plus the dense maps. Eager PyTorch computes every map it is asked for
(there is no compiler to drop unread outputs), so the full-resolution
descriptor maps `normalized_descriptors`, `dense_descriptors` and
`dense_positions` (~760 MB per extractor at the flagship size) are made
only when the caller passes `dense=True`; the inference path does not.
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
    sample_descriptors_lowres, upsample_descriptors, dense_descriptors,
    dense_positions,
)
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
    remove_border_points zeroes the tensor in place)."""
    probability = logits_to_prob(logits)          # (B, hp, wp, cell^2+1)
    score = depth_to_space(probability, cfg.cell_size)     # (B, Hp, Wp)
    if score_mask is not None:
        mask = score_mask[..., 0] if score_mask.ndim == 4 else score_mask
        if padder is not None:
            mask = padder.pad(mask, hw_axes=(-2, -1))
        if cfg.smooth_mask:
            mask = smooth_score_mask(mask)
        score = torch.where(mask, score, torch.zeros_like(score))
    return probability, remove_border_scores(score, cfg.remove_borders)


def _check_cell(cfg: KeypointExtractorConfig) -> None:
    if (cfg.cell_size != 8 or cfg.sparse_desc_from != "lowres"
            or cfg.coord_offset):
        raise NotImplementedError("only the cell-8 extractor is ported")


def _normalized_descriptors(raw_desc: torch.Tensor,
                            padded_size: Tuple[int, int],
                            padder: Optional[Padder],
                            cfg: KeypointExtractorConfig) -> torch.Tensor:
    """The full-resolution L2-normalised descriptor map, unpadded."""
    normalized = upsample_descriptors(raw_desc, padded_size,
                                      cfg.descriptor_scale_factor)
    return padder.unpad(normalized) if padder is not None else normalized


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
    _check_cell(cfg)
    B = logits.shape[0]
    padded_size = (logits.shape[1] * cfg.cell_size,
                   logits.shape[2] * cfg.cell_size)
    probability, bordered = _score_maps(logits, padder, cfg, score_mask)
    return {
        "image_size": _image_size(B, image_size, logits.device),
        "backbone_feats": feats,
        "logits": logits,
        "raw_descriptors": raw_desc,
        "probability": probability,
        "score": (padder.unpad(bordered, hw_axes=(-2, -1))
                  if padder is not None else bordered),
        "coarse_descriptors": normalize_descriptors(
            raw_desc, cfg.descriptor_scale_factor),
        "normalized_descriptors": _normalized_descriptors(
            raw_desc, padded_size, padder, cfg),
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

    feats/logits/raw_desc are NHWC maps on the *padded* grid; `image_size`
    is the original (H, W). Pipeline order: probability -> pixel-shuffle
    score -> event mask -> border removal -> NMS -> top-k threshold ->
    descriptor sampling -> unpad & in-image filtering. Keypoint selection
    carries no gradient (the JAX package's stop_gradient around the NMS):
    the NMS reads a detached score map, so the kept map and the positions'
    scores are constants. Cell 8 only in this slice (the cell-1 extractors
    come later)."""
    _check_cell(cfg)
    H, W = image_size
    B = logits.shape[0]
    padded_size = (logits.shape[1] * cfg.cell_size,
                   logits.shape[2] * cfg.cell_size)
    probability, bordered = _score_maps(logits, padder, cfg, score_mask)
    nms_map = nms(bordered.detach(), cfg.nms_radius, impl=cfg.nms_impl)
    # after nms(radius=r) survivors are > r apart, so top-k may first
    # reduce to per-(r+1)-block candidates
    positions, valid = select_topk_keypoints(
        nms_map, cfg.detection_top_k, cfg.detection_threshold, cfg.ordering,
        min_distance=cfg.nms_radius + 1)

    sparse_desc = sample_descriptors_lowres(
        raw_desc, positions, padded_size, cfg.descriptor_scale_factor, True,
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

    # thresholded dense NMS map: only the selected keypoints' scores
    Hs, Ws = score_u.shape[1], score_u.shape[2]
    iy = torch.floor(py).to(torch.int64).clamp(0, Hs - 1)
    ix = torch.floor(px).to(torch.int64).clamp(0, Ws - 1)
    kept = torch.zeros(B, Hs * Ws, dtype=score_u.dtype, device=logits.device)
    kept.scatter_add_(1, iy * Ws + ix, torch.where(
        valid, positions[..., 2], torch.zeros_like(positions[..., 2])))

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
        normalized = _normalized_descriptors(raw_desc, padded_size, padder,
                                             cfg)
        out["normalized_descriptors"] = normalized
        out["dense_descriptors"] = dense_descriptors(normalized)
        out["dense_positions"] = dense_positions(score_u, cfg.ordering)
    return out


class VGGExtractor(nn.Module):
    """Event keypoint extractor at cell 8 (VGG backbone + detector and
    descriptor heads + postprocessing). Input (B, H, W, C) NHWC."""

    def __init__(self, config: KeypointExtractorConfig = KeypointExtractorConfig(),
                 in_channels: int = 16, feat_channels: int = 128,
                 descriptor_dim: int = 256, lat_channels: int = 256,
                 use_batchnorm: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        self.backbone = VGGBackbone(in_channels, feat_channels, use_batchnorm,
                                    dtype)
        self.detector_head = VGGDetectorHead(
            feat_channels, lat_channels, 65, use_batchnorm, dtype)
        self.descriptor_head = VGGDescriptorHead(
            feat_channels, descriptor_dim, use_batchnorm, dtype)

    def _heads(self, x: torch.Tensor):
        """Backbone and heads on the padded input: the leading arguments of
        `extract_keypoints` / `extract_dense`."""
        assert x.ndim == 4, "expected NHWC input"
        H, W = x.shape[1], x.shape[2]
        padder = Padder(H, W, 8)
        x = padder.pad(x).permute(0, 3, 1, 2)    # NCHW view, channels-last
        feats = self.backbone(x)
        logits = self.detector_head(feats)
        raw_desc = self.descriptor_head(feats)
        return (feats.permute(0, 2, 3, 1), logits.permute(0, 2, 3, 1).float(),
                raw_desc.permute(0, 2, 3, 1).float(), (H, W), padder)

    def forward(self, x: torch.Tensor,
                score_mask: Optional[torch.Tensor] = None,
                dense: bool = False) -> Dict[str, Any]:
        return extract_keypoints(*self._heads(x), self.config, score_mask,
                                 dense)

    def dense_maps(self, x: torch.Tensor,
                   score_mask: Optional[torch.Tensor] = None
                   ) -> Dict[str, Any]:
        """The dense maps only (`extract_dense`): the stage-1 forward."""
        return extract_dense(*self._heads(x), self.config, score_mask)
