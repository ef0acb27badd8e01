"""Ground-truth matches from pose and depth, or from a known homography:
the stage-2 supervision.

Counterpart of `ei_nexus_tpu/geometry/gt_matches.py`
(`gt_matches_from_pose_depth`, `gt_matches_from_homography`), with the
same labels: a match index, -1 unmatched, -2 ignored. Argmin ties, and
rows that are all +inf, go to the first index, as with `jnp.argmin`.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .camera import Camera
from .depthproj import project, sample_depth
from .epipolar import T_to_E, sym_epipolar_distance_all
from .homography import warp_points_homography
from .se3 import Pose

IGNORE_FEATURE = -2
UNMATCHED_FEATURE = -1


def _mutual_min_assignment(dist: torch.Tensor, pos_th: float):
    """Mutual row/column argmin positives under a squared threshold."""
    min0 = dist.argmin(dim=-1)   # (..., N)
    min1 = dist.argmin(dim=-2)   # (..., M)
    N, M = dist.shape[-2], dist.shape[-1]
    ismin0 = torch.arange(M, device=dist.device) == min0[..., None]
    ismin1 = torch.arange(N, device=dist.device)[:, None] == min1[..., None, :]
    positive = ismin0 & ismin1 & (dist < pos_th ** 2)
    return positive, min0, min1


def _pack_labels(positive, min0, min1, negative0, negative1):
    ignore = torch.full_like(min0, IGNORE_FEATURE)
    m0 = torch.where(positive.any(dim=-1), min0, ignore)
    m1 = torch.where(positive.any(dim=-2), min1,
                     torch.full_like(min1, IGNORE_FEATURE))
    m0 = torch.where(negative0, torch.full_like(m0, UNMATCHED_FEATURE), m0)
    m1 = torch.where(negative1, torch.full_like(m1, UNMATCHED_FEATURE), m1)
    return m0, m1


def gt_matches_from_pose_depth(
    kp0: torch.Tensor, kp1: torch.Tensor, camera0: Camera, camera1: Camera,
    depth0: torch.Tensor, depth1: torch.Tensor, T_0to1: Pose, T_1to0: Pose,
    pos_th: float = 3.0, neg_th: float = 5.0, ordering: str = "yx",
    epi_th: Optional[float] = None, cc_th: Optional[float] = None,
    mask0: Optional[torch.Tensor] = None,
    mask1: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """GT matches between kp0 (B, N, 2) and kp1 (B, M, 2) (ordering "yx" or
    "xy") through depth reprojection; cameras and poses batched (B,),
    depths (B, H, W) with <= 0 invalid. Returns assignment (B, N, M),
    matches0/1 int32, matching_scores0/1, reward, proj_0to1/1to0,
    visible0/1 and depth_keypoints0/1, as the JAX package."""
    assert ordering in ("yx", "xy")
    if ordering == "yx":
        kp0 = kp0.flip(-1)
        kp1 = kp1.flip(-1)
    kp0 = kp0[..., :2]
    kp1 = kp1[..., :2]

    d0, valid0 = sample_depth(kp0, depth0)
    d1, valid1 = sample_depth(kp1, depth1)
    if mask0 is not None:
        valid0 = valid0 & mask0
    if mask1 is not None:
        valid1 = valid1 & mask1

    kp0_1, visible0 = project(kp0, d0, depth1, camera0, camera1, T_0to1,
                              valid0, ccth=cc_th)
    kp1_0, visible1 = project(kp1, d1, depth0, camera1, camera0, T_1to0,
                              valid1, ccth=cc_th)
    mask_visible = visible0[..., :, None] & visible1[..., None, :]

    # (..., N, M): the larger of the forward and backward errors
    dist0 = ((kp0_1[..., :, None, :] - kp1[..., None, :, :]) ** 2).sum(-1)
    dist1 = ((kp0[..., :, None, :] - kp1_0[..., None, :, :]) ** 2).sum(-1)
    dist = torch.maximum(dist0, dist1)
    inf = torch.full_like(dist, float("inf"))
    dist = torch.where(mask_visible, dist, inf)

    positive, min0, min1 = _mutual_min_assignment(dist, pos_th)
    negative0 = (dist0.amin(dim=-1) > neg_th ** 2) & valid0
    negative1 = (dist1.amin(dim=-2) > neg_th ** 2) & valid1
    m0, m1 = _pack_labels(positive, min0, min1, negative0, negative1)

    # inv_ex: no host-side singularity check (that would synchronise)
    K1inv = torch.linalg.inv_ex(camera1.calibration_matrix())[0]
    K0inv = torch.linalg.inv_ex(camera0.calibration_matrix())[0]
    F = K1inv.mT @ T_to_E(T_0to1) @ K0inv
    epi_dist = sym_epipolar_distance_all(kp0, kp1, F)

    if epi_th is not None:
        mask_ignore = ((m0[..., :, None] == IGNORE_FEATURE)
                       & (m1[..., None, :] == IGNORE_FEATURE))
        epi_gated = torch.where(mask_ignore, epi_dist, inf)
        exclude0 = epi_gated.amin(dim=-1) > neg_th
        exclude1 = epi_gated.amin(dim=-2) > neg_th
        m0 = torch.where(~valid0 & exclude0,
                         torch.full_like(m0, UNMATCHED_FEATURE), m0)
        m1 = torch.where(~valid1 & exclude1,
                         torch.full_like(m1, UNMATCHED_FEATURE), m1)

    if mask0 is not None:
        m0 = torch.where(mask0, m0, torch.full_like(m0, IGNORE_FEATURE))
        positive = positive & mask0[..., :, None]
    if mask1 is not None:
        m1 = torch.where(mask1, m1, torch.full_like(m1, IGNORE_FEATURE))
        positive = positive & mask1[..., None, :]

    return {
        "assignment": positive,
        "reward": (dist < pos_th ** 2).float() - (epi_dist > neg_th).float(),
        "matches0": m0.to(torch.int32),
        "matches1": m1.to(torch.int32),
        "matching_scores0": (m0 > -1).float(),
        "matching_scores1": (m1 > -1).float(),
        "depth_keypoints0": d0,
        "depth_keypoints1": d1,
        "proj_0to1": kp0_1,
        "proj_1to0": kp1_0,
        "visible0": visible0,
        "visible1": visible1,
    }


def gt_matches_from_homography(
    kp0: torch.Tensor, kp1: torch.Tensor, H: torch.Tensor,
    pos_th: float = 3.0, neg_th: float = 6.0,
    mask0: Optional[torch.Tensor] = None,
    mask1: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """GT matches between kp0 (B, N, 2) and kp1 (B, M, 2), both xy, from a
    known homography H (B, 3, 3) mapping view 0 to view 1. Slots outside
    `mask0` / `mask1` take no part in the assignment and are labelled
    IGNORE. Returns assignment (B, N, M), reward, matches0/1 int32,
    matching_scores0/1 and proj_0to1/1to0, as the JAX package."""
    kp0 = kp0[..., :2]
    kp1 = kp1[..., :2]
    kp0_1 = warp_points_homography(kp0, H, inverse=False)
    kp1_0 = warp_points_homography(kp1, H, inverse=True)

    dist0 = ((kp0_1[..., :, None, :] - kp1[..., None, :, :]) ** 2).sum(-1)
    dist1 = ((kp0[..., :, None, :] - kp1_0[..., None, :, :]) ** 2).sum(-1)
    dist = torch.maximum(dist0, dist1)
    inf = torch.full_like(dist, float("inf"))
    if mask0 is not None:
        dist = torch.where(mask0[..., :, None], dist, inf)
    if mask1 is not None:
        dist = torch.where(mask1[..., None, :], dist, inf)

    reward = (dist < pos_th ** 2).float() - (dist > neg_th ** 2).float()
    positive, min0, min1 = _mutual_min_assignment(dist, pos_th)
    negative0 = dist0.amin(dim=-1) > neg_th ** 2
    negative1 = dist1.amin(dim=-2) > neg_th ** 2
    m0, m1 = _pack_labels(positive, min0, min1, negative0, negative1)
    if mask0 is not None:
        m0 = torch.where(mask0, m0, torch.full_like(m0, IGNORE_FEATURE))
    if mask1 is not None:
        m1 = torch.where(mask1, m1, torch.full_like(m1, IGNORE_FEATURE))

    return {
        "assignment": positive,
        "reward": reward,
        "matches0": m0.to(torch.int32),
        "matches1": m1.to(torch.int32),
        "matching_scores0": (m0 > -1).float(),
        "matching_scores1": (m1 > -1).float(),
        "proj_0to1": kp0_1,
        "proj_1to0": kp1_0,
    }
