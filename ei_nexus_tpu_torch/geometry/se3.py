"""Batched SE(3) rigid transforms.

Counterpart of `ei_nexus_tpu/geometry/se3.py`: `R` is (..., 3, 3), `t` is
(..., 3); `T_A2B.transform(p_A) -> p_B`.
"""

from __future__ import annotations

import dataclasses

import torch


def skew_symmetric(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of a (..., 3) vector."""
    z = torch.zeros_like(v[..., 0])
    rows = [z, -v[..., 2], v[..., 1],
            v[..., 2], z, -v[..., 0],
            -v[..., 1], v[..., 0], z]
    return torch.stack(rows, dim=-1).unflatten(-1, (3, 3))


def to_homogeneous(points: torch.Tensor) -> torch.Tensor:
    """(..., N) -> (..., N+1) with a trailing 1."""
    return torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)


@dataclasses.dataclass(frozen=True)
class Pose:
    """Batched SE(3) transform; the fields broadcast over leading dims."""

    R: torch.Tensor  # (..., 3, 3)
    t: torch.Tensor  # (..., 3)

    @classmethod
    def from_4x4mat(cls, T) -> "Pose":
        T = torch.as_tensor(T)
        return cls(R=T[..., :3, :3], t=T[..., :3, 3])

    def inv(self) -> "Pose":
        Rinv = self.R.mT
        return Pose(R=Rinv, t=-(Rinv @ self.t[..., None])[..., 0])

    def transform(self, p3d: torch.Tensor) -> torch.Tensor:
        """Apply to (..., N, 3) points."""
        return p3d @ self.R.mT + self.t[..., None, :]
