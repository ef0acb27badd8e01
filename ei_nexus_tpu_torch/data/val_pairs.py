"""Evaluation-pair generation: select (view0, view1) frame pairs with enough
ground-truth-matchable overlap.

Counterpart of `ei_nexus_tpu/data/val_pairs.py` (the reference's
generate_MVSEC_relative_pose_val.py and generate_EC_val.py): sample
candidate pairs within a frame window, compute dense-grid GT matches from
pose and depth (`geometry.gt_matches_from_pose_depth`, on the card
unless the caller names another device), and keep the pairs whose
matchable ratio lies in (lo, hi): enough overlap, but not a trivial one.
The random draws are numpy's, from a `np.random.Generator`, in the JAX
package's order.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from ..device import resolve_device
from ..geometry import Camera, Pose, gt_matches_from_pose_depth


def generate_candidate_pairs(n_frames: int, time_window: int = 60,
                             num_pairs: int = 500,
                             rng: Optional[np.random.Generator] = None
                             ) -> np.ndarray:
    """Random (i, j) candidates with j in [i, i + window)."""
    rng = rng or np.random.default_rng()
    i1 = rng.integers(0, n_frames - 1, num_pairs)
    i2 = np.array([rng.integers(i, min(n_frames - 1, i + time_window) + 1)
                   for i in i1])
    return np.stack([i1, i2], axis=1)


def _grid_kpts(H: int, W: int, stride: int) -> np.ndarray:
    ys, xs = np.meshgrid(np.arange(0, H, stride), np.arange(0, W, stride),
                         indexing="ij")
    return np.stack([ys.ravel() + 0.5, xs.ravel() + 0.5],
                    -1).astype(np.float32)


def pair_overlap_ratio(depth0: np.ndarray, depth1: np.ndarray,
                       K: np.ndarray, T_0to1: np.ndarray,
                       T_1to0: np.ndarray, stride: int = 4,
                       pos_th: float = 3.0,
                       device: Optional[Union[str, torch.device]] = None
                       ) -> float:
    """matchable / visible over a strided pixel grid, the GT matches
    computed on `device` (the card unless the caller names another)."""
    dev = resolve_device(device)
    H, W = depth0.shape

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)[None]

    kp = f32(_grid_kpts(H, W, stride))
    cam = Camera.from_calibration_matrix(f32(K), size=(W, H))
    gt = gt_matches_from_pose_depth(
        kp, kp, cam, cam, f32(depth0), f32(depth1),
        Pose.from_4x4mat(f32(T_0to1)), Pose.from_4x4mat(f32(T_1to0)),
        pos_th=pos_th, neg_th=5.0, ordering="yx")
    n_match = int((gt["matches0"] > -1).sum())
    vis0 = float(gt["visible0"].sum())
    vis1 = float(gt["visible1"].sum())
    return n_match / max(min(vis0, vis1), 1.0)


def filter_pairs_by_overlap(sequence, candidates: np.ndarray,
                            ratio_lo: float = 0.4, ratio_hi: float = 0.8,
                            stride: int = 4,
                            device: Optional[Union[str, torch.device]] = None
                            ) -> np.ndarray:
    """Keep the candidate pairs whose overlap ratio lies in (lo, hi).
    `sequence` holds `depth`, `depth_ts`, `K` and `pose_interpolator`, as
    the MVSEC reader's sequence does; the ratios computed on `device` (the
    card unless the caller names another)."""
    kept = []
    for i0, i1 in candidates:
        if i0 == i1:
            continue
        d0 = np.nan_to_num(sequence.depth[i0]).astype(np.float32)
        d1 = np.nan_to_num(sequence.depth[i1]).astype(np.float32)
        pose0 = sequence.pose_interpolator.interpolate(
            float(sequence.depth_ts[i0]))
        pose1 = sequence.pose_interpolator.interpolate(
            float(sequence.depth_ts[i1]))
        T01 = pose1 @ np.linalg.inv(pose0)
        T10 = pose0 @ np.linalg.inv(pose1)
        ratio = pair_overlap_ratio(d0, d1, sequence.K, T01, T10,
                                   stride=stride, device=device)
        if ratio_lo < ratio < ratio_hi:
            kept.append((int(i0), int(i1)))
    return np.asarray(kept, np.int64).reshape(-1, 2)


def sample_final_indices(indices: np.ndarray, num_samples: int,
                         rng: Optional[np.random.Generator] = None
                         ) -> np.ndarray:
    """A uniform subsample of the surviving pairs, in their order."""
    rng = rng or np.random.default_rng()
    if len(indices) <= num_samples:
        return indices
    sel = rng.choice(len(indices), num_samples, replace=False)
    return indices[np.sort(sel)]


def write_indices(path: str, indices: np.ndarray) -> None:
    np.savetxt(path, indices, fmt="%d")
