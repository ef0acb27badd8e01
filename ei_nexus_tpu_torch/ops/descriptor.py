"""Descriptor postprocessing: normalization, sparse sampling, upsampling.

Counterpart of `ei_nexus_tpu/ops/descriptor.py` on NHWC maps and fixed-K
keypoint slots. Coordinate conventions:
 - low-res sampling: full-res positions shifted by -0.5, normalized by
   (padded_size - 1), then bilinearly sampled on the coarse map with
   half-pixel centers and zero padding (grid_sample, align_corners=False);
 - full-resolution sampling (cell 1): the integer (floor) gather, clipped
   to the map;
 - upsampling: half-pixel bilinear resize (F.interpolate,
   align_corners=False), then L2 normalization.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def normalize_descriptors(desc: torch.Tensor, scale_factor: float = 1.0,
                          normalize: bool = True,
                          axis: int = -1) -> torch.Tensor:
    """L2-normalize along the descriptor axis, then scale."""
    if normalize:
        norm = torch.linalg.vector_norm(desc, dim=axis, keepdim=True)
        desc = desc / torch.clamp(norm, min=1e-12)
    return scale_factor * desc


def _bilinear_gather_nhwc(fmap: torch.Tensor, px: torch.Tensor,
                          py: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of (B, H, W, C) at float pixel-index coords (B, K)
    with zero padding outside."""
    B, H, W, C = fmap.shape
    x0 = torch.floor(px).to(torch.int64)
    y0 = torch.floor(py).to(torch.int64)
    wx = (px - x0)[..., None]
    wy = (py - y0)[..., None]
    flat = fmap.reshape(B, H * W, C)

    def gather(xi, yi):
        inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        idx = yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
        vals = torch.gather(flat, 1, idx[..., None].expand(-1, -1, C))
        return torch.where(inb[..., None], vals, torch.zeros_like(vals))

    v00 = gather(x0, y0)
    v01 = gather(x0 + 1, y0)
    v10 = gather(x0, y0 + 1)
    v11 = gather(x0 + 1, y0 + 1)
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    return top * (1 - wy) + bot * wy


def sample_descriptors_lowres(
    raw_desc: torch.Tensor,
    positions: torch.Tensor,
    padded_size: Tuple[int, int],
    scale_factor: float = 1.0,
    normalize: bool = True,
    ordering: str = "yx",
) -> torch.Tensor:
    """Sample a coarse (B, h, w, D) descriptor map at full-res keypoints
    (B, K, >=2) in padded pixel coords:
    pos' = pos - 0.5; u = 2*pos'/(S-1) - 1; l = (u+1)/2 * w_low - 0.5."""
    assert ordering in ("yx", "xy")
    H, W = padded_size
    h, w = raw_desc.shape[1], raw_desc.shape[2]
    if ordering == "yx":
        py_full, px_full = positions[..., 0], positions[..., 1]
    else:
        px_full, py_full = positions[..., 0], positions[..., 1]
    uy = 2.0 * (py_full - 0.5) / (H - 1) - 1.0
    ux = 2.0 * (px_full - 0.5) / (W - 1) - 1.0
    ly = (uy + 1.0) / 2.0 * h - 0.5
    lx = (ux + 1.0) / 2.0 * w - 0.5
    desc = _bilinear_gather_nhwc(raw_desc, lx, ly)
    return normalize_descriptors(desc, scale_factor, normalize)


def sample_descriptors_fullres(
    raw_desc: torch.Tensor,
    positions: torch.Tensor,
    scale_factor: float = 1.0,
    normalize: bool = True,
    ordering: str = "yx",
) -> torch.Tensor:
    """Integer (floor) gather from a full-resolution (B, H, W, D) map at
    (B, K, >=2) positions, clipped to the map, then normalised."""
    assert ordering in ("yx", "xy")
    B, H, W, D = raw_desc.shape
    cols = (0, 1) if ordering == "yx" else (1, 0)
    yi = torch.floor(positions[..., cols[0]]).to(torch.int64).clamp(0, H - 1)
    xi = torch.floor(positions[..., cols[1]]).to(torch.int64).clamp(0, W - 1)
    idx = (yi * W + xi)[..., None].expand(-1, -1, D)
    desc = torch.gather(raw_desc.reshape(B, H * W, D), 1, idx)
    return normalize_descriptors(desc, scale_factor, normalize)


def upsample_descriptors(raw_desc: torch.Tensor, image_size: Tuple[int, int],
                         scale_factor: float = 1.0) -> torch.Tensor:
    """Bilinear-resize a coarse (B, h, w, D) map to (B, H, W, D), then
    L2-normalize."""
    up = F.interpolate(raw_desc.permute(0, 3, 1, 2), size=tuple(image_size),
                       mode="bilinear", align_corners=False)
    return normalize_descriptors(up.permute(0, 2, 3, 1), scale_factor)


def dense_descriptors(normalized_desc: torch.Tensor) -> torch.Tensor:
    """(B, H, W, D) -> (B, H*W, D) row-major flatten."""
    B, H, W, D = normalized_desc.shape
    return normalized_desc.reshape(B, H * W, D)
