"""Homography warping and random homography sampling.

Counterpart of `ei_nexus_tpu/geometry/homography.py`: warping is torch on
whatever device its inputs lie; random homography sampling is host-side
numpy from a `np.random.Generator`, used by augmentation only, with the
JAX package's arithmetic (its final corner warp in float32, as the JAX
package computes it).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .se3 import to_homogeneous


def warp_points_homography(points: torch.Tensor, H: torch.Tensor,
                           inverse: bool = True) -> torch.Tensor:
    """Warp (..., N, 2) xy points with a (..., 3, 3) homography, or with
    its inverse (the default)."""
    # inv_ex: no singularity check, which would wait for the device
    M = torch.linalg.inv_ex(H)[0] if inverse else H
    w = to_homogeneous(points) @ M.mT
    return w[..., :2] / (w[..., 2:] + 1e-5)


def warp_points_prob(points_xyp: torch.Tensor, H: torch.Tensor
                     ) -> torch.Tensor:
    """Warp (..., N, 3) (x, y, prob) points forward with H, keeping prob."""
    warped = warp_points_homography(points_xyp[..., :2], H, inverse=False)
    return torch.cat([warped, points_xyp[..., 2:]], dim=-1)


# ---------------------------------------------------------------------------
# host-side random homography sampling (augmentation only)
# ---------------------------------------------------------------------------


def _center_patch(shape, patch_shape=None):
    if patch_shape is None:
        patch_shape = shape
    width, height = shape
    pwidth, pheight = patch_shape
    left = int((width - pwidth) / 2)
    bottom = int((height - pheight) / 2)
    right = int((width + pwidth) / 2)
    top = int((height + pheight) / 2)
    return np.array([[left, bottom], [left, top], [right, top],
                     [right, bottom]], dtype=np.float64)


def _is_convex(patch, min_convexity=0.05):
    n = patch.shape[0]
    for i in range(n):
        x1, y1 = patch[(i - 1) % n]
        x2, y2 = patch[i]
        x3, y3 = patch[(i + 1) % n]
        if (x2 - x1) * (y3 - y2) - (x3 - x2) * (y2 - y1) > -min_convexity:
            return False
    return True


def compute_homography_4pt(pts1: np.ndarray, pts2: np.ndarray) -> np.ndarray:
    """DLT solve of the 3x3 homography mapping 4 source points to 4
    targets (float64)."""
    rows = []
    rhs = []
    for (px, py), (qx, qy) in zip(pts1, pts2):
        rows.append([px, py, 1, 0, 0, 0, -px * qx, -py * qx])
        rows.append([0, 0, 0, px, py, 1, -px * qy, -py * qy])
        rhs.extend([qx, qy])
    h = np.linalg.solve(np.asarray(rows), np.asarray(rhs))
    return np.concatenate([h, [1.0]]).reshape(3, 3)


def sample_homography_corners(shape, patch_shape, difficulty: float = 1.0,
                              translation: float = 0.4, n_angles: int = 10,
                              max_angle: float = 90.0,
                              min_convexity: float = 0.05,
                              rng: np.random.Generator | None = None):
    """A random perspective transform from a perturbed centred patch:
    returns (H, corners, warped_corners, patch_shape), the draws taken
    from `rng` in the JAX package's order."""
    rng = np.random.default_rng() if rng is None else rng
    max_angle_rad = max_angle / 180.0 * math.pi
    width, height = shape
    pwidth, pheight = width * (1 - difficulty), height * (1 - difficulty)
    min_pts1 = _center_patch(shape, (pwidth, pheight))
    full = _center_patch(shape)
    pts2 = _center_patch(patch_shape)
    scale = min_pts1 - full
    for _ in range(1000):
        offsets = rng.uniform(0.0, 1.0, size=(4, 2)) * scale
        pts1 = full + offsets
        if _is_convex(pts1 / np.array(shape), min_convexity):
            break

    # re-centre on the shrunken patch
    pts1 = pts1 - pts1.mean(axis=0, keepdims=True) + min_pts1.mean(
        axis=0, keepdims=True)

    # rotation: the first candidate angle that keeps the patch in the frame
    if n_angles > 0 and difficulty > 0:
        angles = np.linspace(-max_angle_rad * difficulty,
                             max_angle_rad * difficulty, n_angles)
        rng.shuffle(angles)
        center = pts1.mean(axis=0, keepdims=True)
        for ang in angles:
            rot = np.array([[math.cos(ang), -math.sin(ang)],
                            [math.sin(ang), math.cos(ang)]])
            rotated = (pts1 - center) @ rot + center
            if np.all((rotated / np.array(shape) >= 0.0)
                      & (rotated / np.array(shape) < 1.0)):
                pts1 = rotated
                break

    # translation within the frame
    if translation > 0:
        min_trans = -pts1.min(axis=0)
        max_trans = np.array(shape) - pts1.max(axis=0)
        trans = rng.uniform(min_trans, max_trans)
        pts1 = pts1 + trans[None] * translation * difficulty

    H = compute_homography_4pt(pts1, pts2)
    # float32, as the JAX package's device arrays compute it
    warped = warp_points_homography(
        torch.as_tensor(full, dtype=torch.float32),
        torch.as_tensor(H, dtype=torch.float32), inverse=False).numpy()
    return H, full, warped, patch_shape
