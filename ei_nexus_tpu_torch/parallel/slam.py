"""The SLAM back end's assembly: matches -> tracks -> landmarks -> a
bundle-adjusted trajectory.

Counterpart of `ei_nexus_tpu/parallel/slam.py`: the front end's fixed-K
keypoints and consecutive-pair matches fill a keyframe store, the matches
are chained into multi-view tracks, landmarks come from linear
triangulation (geometry/triangulation.py) and are refined jointly with
the poses by `ba.ba_solve`. The graph bookkeeping is numpy on the host;
triangulation and the solve run on `device` (the card unless the caller
names another).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from ..geometry import Camera, Pose
from ..geometry.triangulation import triangulate_tracks
from .ba import BAProblem, ba_solve


@dataclass
class Keyframe:
    """One keyframe: fixed-K keypoints (y, x, prob) with validity, an
    initial world->camera pose (4x4) and intrinsics K (3x3)."""

    keypoints: np.ndarray        # (K, 3) (y, x, prob)
    valid: np.ndarray            # (K,)
    pose: np.ndarray             # (4, 4) world->camera
    K: np.ndarray                # (3, 3)


def chain_tracks(matches01: Sequence[np.ndarray],
                 n_keypoints: int) -> List[List[Tuple[int, int]]]:
    """Chain per-pair matches (frame i -> i+1, arrays of matches0 indices,
    -1 unmatched) into multi-view tracks of (frame, keypoint) pairs; tracks
    of at least two views."""
    track_of: Dict[Tuple[int, int], int] = {}
    tracks: List[List[Tuple[int, int]]] = []
    for f, m in enumerate(matches01):
        for i, j in enumerate(np.asarray(m)):
            if j < 0:
                continue
            t = track_of.get((f, i))
            if t is None:
                t = len(tracks)
                tracks.append([(f, int(i))])
            tracks[t].append((f + 1, int(j)))
            track_of[(f + 1, int(j))] = t
    return [t for t in tracks if len(t) >= 2]


def _so3log_np(R: np.ndarray, eps: float = 1e-8) -> np.ndarray:
    """`ba._so3log` in float32 numpy, for the host's pose twists."""
    R = np.asarray(R, np.float32)
    trace = np.trace(R, axis1=-2, axis2=-1)
    axis = np.stack([R[..., 2, 1] - R[..., 1, 2],
                     R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], axis=-1)
    norm = np.sqrt(np.sum(axis ** 2, axis=-1) + np.float32(eps))
    theta = np.arctan2(norm, trace - np.float32(1.0))
    small = norm < 1e-6
    scale = np.where(small, np.float32(0.5),
                     theta / np.where(small, np.float32(1.0), norm))
    return (axis * scale[..., None]).astype(np.float32)


def build_ba_problem(keyframes: Sequence[Keyframe],
                     tracks: Sequence[Sequence[Tuple[int, int]]],
                     min_track_len: int = 2, fix_first: bool = True,
                     device: Optional[Union[str, torch.device]] = None
                     ) -> Optional[BAProblem]:
    """Triangulate the tracks and assemble a fixed-shape BAProblem on
    `device` (the card unless the caller names another); None without a
    track of `min_track_len` views."""
    dev = resolve_device(device)
    M = len(keyframes)
    poses6 = np.asarray(
        [np.concatenate([_so3log_np(kf.pose[None, :3, :3])[0],
                         kf.pose[:3, 3]]) for kf in keyframes], np.float32)
    intr = np.asarray([[kf.K[0, 0], kf.K[1, 1], kf.K[0, 2], kf.K[1, 2]]
                       for kf in keyframes], np.float32)
    kept = [t for t in tracks if len(t) >= min_track_len]
    if not kept:
        return None
    L = len(kept)
    obs_pose, obs_point, obs_uv = [], [], []
    kp_arr = np.zeros((L, M, 2), np.float32)
    msk = np.zeros((L, M), bool)
    for li, tr in enumerate(kept):
        for f, i in tr:
            kp = keyframes[f].keypoints[i]
            uv = np.array([kp[1], kp[0]], np.float32)       # yx -> xy
            obs_pose.append(f)
            obs_point.append(li)
            obs_uv.append(uv)
            kp_arr[li, f] = uv
            msk[li, f] = True
    cams = Camera.from_calibration_matrix(torch.as_tensor(
        np.stack([kf.K for kf in keyframes]).astype(np.float32),
        device=dev))
    poses = Pose.from_4x4mat(torch.as_tensor(
        np.stack([kf.pose for kf in keyframes]).astype(np.float32),
        device=dev))
    points = triangulate_tracks(torch.as_tensor(kp_arr, device=dev), poses,
                                cams, torch.as_tensor(msk, device=dev))
    fixed = np.zeros(M, bool)
    fixed[0] = fix_first

    def t(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    return BAProblem(
        poses=t(poses6, torch.float32),
        intrinsics=t(intr, torch.float32),
        points=points.float(),
        obs_pose=t(obs_pose, torch.int32),
        obs_point=t(obs_point, torch.int32),
        obs_uv=t(np.stack(obs_uv), torch.float32),
        obs_valid=torch.ones(len(obs_pose), dtype=torch.bool, device=dev),
        fixed_poses=t(fixed, torch.bool))


def refine_map(keyframes: Sequence[Keyframe],
               matches01: Sequence[np.ndarray], iters: int = 10,
               device: Optional[Union[str, torch.device]] = None
               ) -> Tuple[Optional[BAProblem], np.ndarray]:
    """Chain tracks, triangulate, bundle-adjust on `device`. Returns (the
    refined BAProblem or None, the cost history (iters + 1,))."""
    tracks = chain_tracks(matches01, keyframes[0].keypoints.shape[0])
    prob = build_ba_problem(keyframes, tracks, device=device)
    if prob is None:
        return None, np.zeros(0)
    refined, errs = ba_solve(prob, iters=iters)
    return refined, errs.cpu().numpy()
