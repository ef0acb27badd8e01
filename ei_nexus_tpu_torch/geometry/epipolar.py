"""Epipolar geometry of the stage-2 supervision.

Counterpart of the parts of `ei_nexus_tpu/geometry/epipolar.py` that the
ground-truth generator uses: the essential matrix of a pose and the
all-pairs symmetric epipolar distance.
"""

from __future__ import annotations

import torch

from .se3 import Pose, skew_symmetric, to_homogeneous


def T_to_E(T: Pose) -> torch.Tensor:
    """Pose -> essential matrix E = [t]x R."""
    return skew_symmetric(T.t) @ T.R


def sym_epipolar_distance_all(p0: torch.Tensor, p1: torch.Tensor,
                              E: torch.Tensor, eps: float = 1e-15
                              ) -> torch.Tensor:
    """All-pairs symmetric epipolar distance: p0 (..., N, 2|3), p1
    (..., M, 2|3), E (..., 3, 3) -> (..., N, M)."""
    if p0.shape[-1] != 3:
        p0 = to_homogeneous(p0)
    if p1.shape[-1] != 3:
        p1 = to_homogeneous(p1)
    p1_E_p0 = torch.einsum("...mi,...ij,...nj->...nm", p1, E, p0).abs()
    E_p0 = torch.einsum("...ij,...nj->...ni", E, p0)
    Et_p1 = torch.einsum("...ij,...mi->...mj", E, p1)
    d0 = p1_E_p0 / torch.sqrt(E_p0[..., None, 0] ** 2
                              + E_p0[..., None, 1] ** 2 + eps)
    d1 = p1_E_p0 / torch.sqrt(Et_p1[..., None, :, 0] ** 2
                              + Et_p1[..., None, :, 1] ** 2 + eps)
    return (d0 + d1) / 2
