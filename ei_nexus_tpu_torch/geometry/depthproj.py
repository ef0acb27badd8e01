"""Depth sampling, cross-view keypoint reprojection and dense warps.

Counterpart of `ei_nexus_tpu/geometry/depthproj.py`: fixed-shape gathers
with half-pixel centres (the value of pixel (i, j) lives at (j + 0.5,
i + 0.5)) and zero padding outside the map; points are (x, y) pixels.
"""

from __future__ import annotations

from typing import Optional

import torch

from .camera import Camera
from .se3 import Pose


def _gather_hw(fmap: torch.Tensor, xi: torch.Tensor,
               yi: torch.Tensor) -> torch.Tensor:
    """fmap[..., y, x] for (..., H, W) maps and (..., N) integer indices,
    zero outside the map."""
    H, W = fmap.shape[-2], fmap.shape[-1]
    inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
    idx = yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
    vals = torch.gather(fmap.flatten(-2), -1, idx)
    return torch.where(inb, vals, torch.zeros_like(vals))


def bilinear_sample_map(fmap: torch.Tensor, pts: torch.Tensor
                        ) -> torch.Tensor:
    """Bilinear sample of (..., H, W) at (..., N, 2) xy pixels; NaNs in
    `fmap` reach every sample that touches them."""
    x = pts[..., 0] - 0.5
    y = pts[..., 1] - 0.5
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    wx = x - x0.to(x.dtype)
    wy = y - y0.to(y.dtype)
    v00 = _gather_hw(fmap, x0, y0)
    v01 = _gather_hw(fmap, x0 + 1, y0)
    v10 = _gather_hw(fmap, x0, y0 + 1)
    v11 = _gather_hw(fmap, x0 + 1, y0 + 1)
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    return top * (1 - wy) + bot * wy


def nearest_sample_map(fmap: torch.Tensor, pts: torch.Tensor
                       ) -> torch.Tensor:
    """Nearest-neighbour sample, same half-pixel convention."""
    return _gather_hw(fmap, torch.floor(pts[..., 0]).long(),
                      torch.floor(pts[..., 1]).long())


def sample_depth(pts: torch.Tensor, depth: torch.Tensor):
    """Bilinear depth lookup falling back to nearest where the bilinear
    footprint touches an invalid (<= 0) pixel: pts (..., N, 2) xy, depth
    (..., H, W) -> (depth (..., N), valid (..., N))."""
    d = torch.where(depth > 0, depth, torch.full_like(depth, float("nan")))
    lin = bilinear_sample_map(d, pts)
    near = nearest_sample_map(d, pts)
    interp = torch.where(torch.isnan(lin), near, lin)
    valid = ~torch.isnan(interp) & (interp > 0)
    return torch.nan_to_num(interp), valid


def project(kpi: torch.Tensor, di: torch.Tensor,
            depthj: Optional[torch.Tensor], camera_i: Camera,
            camera_j: Camera, T_itoj: Pose, validi: torch.Tensor,
            ccth: Optional[float] = None):
    """Reproject (..., N, 2) xy keypoints of view i with depths (..., N)
    into view j -> (kpi_j (..., N, 2), visible (..., N)); with `ccth`, also
    require a round trip through view j's depth within ccth px^2."""
    kpi_3d_j = T_itoj.transform(camera_i.image2cam(kpi) * di[..., None])
    kpi_j, validj = camera_j.cam2image(kpi_3d_j)
    valid = validi & validj
    if depthj is None or ccth is None:
        return kpi_j, valid
    dj, validdj = sample_depth(kpi_j, depthj)
    kpi_j_3d_j = camera_j.image2cam(kpi_j) * dj[..., None]
    kpi_j_i, validj_i = camera_i.cam2image(
        T_itoj.inv().transform(kpi_j_3d_j))
    consistent = ((kpi - kpi_j_i) ** 2).sum(dim=-1) < ccth
    return kpi_j, valid & consistent & validj_i & validdj


def dense_warp_consistency(depthi: torch.Tensor, depthj: torch.Tensor,
                           T_itoj: Pose, camera_i: Camera, camera_j: Camera,
                           **kwargs):
    """Warp every pixel centre of view i, with its depth, into view j:
    depthi, depthj (..., H, W) -> (points in view j (..., H, W, 2) xy,
    valid (..., H, W)); `kwargs` go to `project` (`ccth`: the round-trip
    consistency check through view j's depth)."""
    H, W = depthi.shape[-2:]
    ys, xs = torch.meshgrid(
        torch.arange(H, dtype=depthi.dtype, device=depthi.device),
        torch.arange(W, dtype=depthi.dtype, device=depthi.device),
        indexing="ij")
    kpi = torch.stack([xs, ys], dim=-1).reshape(1, H * W, 2) + 0.5
    kpi = kpi.expand(depthi.shape[:-2] + (H * W, 2))
    di = depthi.reshape(depthi.shape[:-2] + (H * W,))
    kpir, validir = project(kpi, di, depthj, camera_i, camera_j, T_itoj,
                            di > 0, **kwargs)
    return (kpir.reshape(depthi.shape[:-2] + (H, W, 2)),
            validir.reshape(depthi.shape[:-2] + (H, W)))
