"""Multi-view linear triangulation.

Counterpart of `ei_nexus_tpu/geometry/triangulation.py`: the DLT of a
track seen in V views, batched over tracks, the landmark initialiser of
the bundle adjustment (parallel/ba.py).
"""

from __future__ import annotations

from typing import Optional

import torch

from .camera import Camera
from .se3 import Pose


def triangulate_tracks(kpts_xy: torch.Tensor, poses: Pose, cams: Camera,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Tracks (T, V, 2) pixel observations in V views (world -> camera
    `poses`, `cams`; mask (T, V) validity) -> (T, 3) world points: the
    right singular vector of the smallest singular value of each track's
    (2V, 4) homogeneous system (u rows, then v rows; masked views' rows
    zeroed), from one batched `torch.linalg.svd(full_matrices=True)`."""
    K = cams.calibration_matrix()                               # (V, 3, 3)
    P = K @ torch.cat([poses.R, poses.t[..., None]], dim=-1)    # (V, 3, 4)
    u = kpts_xy[..., 0, None]
    v = kpts_xy[..., 1, None]
    rows = torch.cat([u * P[:, 2] - P[:, 0],
                      v * P[:, 2] - P[:, 1]], dim=-2)           # (T, 2V, 4)
    if mask is not None:
        rows = rows * torch.cat([mask, mask], dim=-1)[..., None]
    _, _, Vt = torch.linalg.svd(rows, full_matrices=True)
    X = Vt[..., -1, :]
    w = X[..., 3]
    return X[..., :3] / torch.where(w.abs() < 1e-12,
                                    torch.full_like(w, 1e-12), w)[..., None]


def triangulate_linear(kpts_xy: torch.Tensor, poses: Pose, cams: Camera,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One track: (V, 2) observations -> (3,) world point."""
    return triangulate_tracks(kpts_xy[None], poses, cams,
                              None if mask is None else mask[None])[0]
