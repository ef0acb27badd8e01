"""Batched SE(3) rigid transforms.

Counterpart of `ei_nexus_tpu/geometry/se3.py`: `R` is (..., 3, 3), `t` is
(..., 3); `T_A2B.transform(p_A) -> p_B`; composition
`T_B2C @ T_A2B -> T_A2C`.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..device import resolve_device


def skew_symmetric(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of a (..., 3) vector."""
    z = torch.zeros_like(v[..., 0])
    rows = [z, -v[..., 2], v[..., 1],
            v[..., 2], z, -v[..., 0],
            -v[..., 1], v[..., 0], z]
    return torch.stack(rows, dim=-1).unflatten(-1, (3, 3))


def so3exp_map(w: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Rodrigues' formula: (..., 3) axis-angle -> (..., 3, 3) rotation;
    below `eps` radians the first-order term."""
    theta = torch.linalg.vector_norm(w, dim=-1, keepdim=True)
    small = theta < eps
    div = torch.where(small, torch.ones_like(theta), theta)
    W = skew_symmetric(w / div)
    th = theta[..., None]
    res = W * torch.sin(th) + (W @ W) * (1.0 - torch.cos(th))
    res = torch.where(small[..., None], W, res)
    return torch.eye(3, dtype=w.dtype, device=w.device) + res


def to_homogeneous(points: torch.Tensor) -> torch.Tensor:
    """(..., N) -> (..., N+1) with a trailing 1."""
    return torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)


def from_homogeneous(points: torch.Tensor, eps: float = 0.0
                     ) -> torch.Tensor:
    """(..., N+1) -> (..., N), divided by the last coordinate."""
    return points[..., :-1] / (points[..., -1:] + eps)


@dataclasses.dataclass(frozen=True)
class Pose:
    """Batched SE(3) transform; the fields broadcast over leading dims."""

    R: torch.Tensor  # (..., 3, 3)
    t: torch.Tensor  # (..., 3)

    @classmethod
    def from_Rt(cls, R, t) -> "Pose":
        return cls(R=torch.as_tensor(R), t=torch.as_tensor(t))

    @classmethod
    def from_aa(cls, aa, t) -> "Pose":
        """From an axis-angle rotation vector and a translation."""
        return cls(R=so3exp_map(torch.as_tensor(aa)), t=torch.as_tensor(t))

    @classmethod
    def from_4x4mat(cls, T) -> "Pose":
        T = torch.as_tensor(T)
        return cls(R=T[..., :3, :3], t=T[..., :3, 3])

    @classmethod
    def identity(cls, batch_shape=(), dtype=torch.float32,
                 device=None) -> "Pose":
        """Identities of `batch_shape` on `device` (the card unless the
        caller names another)."""
        device = resolve_device(device)
        batch_shape = tuple(batch_shape)
        R = torch.eye(3, dtype=dtype, device=device).expand(
            batch_shape + (3, 3))
        return cls(R=R, t=torch.zeros(batch_shape + (3,), dtype=dtype,
                                      device=device))

    @property
    def shape(self):
        return self.t.shape[:-1]

    @property
    def dtype(self):
        return self.t.dtype

    def as_4x4mat(self) -> torch.Tensor:
        """(..., 4, 4): [R | t] over the row (0, 0, 0, 1)."""
        bottom = torch.zeros(self.shape + (1, 4), dtype=self.dtype,
                             device=self.t.device)
        bottom[..., 0, 3] = 1.0
        top = torch.cat([self.R, self.t[..., None]], dim=-1)
        return torch.cat([top, bottom], dim=-2)

    def inv(self) -> "Pose":
        Rinv = self.R.mT
        return Pose(R=Rinv, t=-(Rinv @ self.t[..., None])[..., 0])

    def compose(self, other: "Pose") -> "Pose":
        """T_B2C.compose(T_A2B) -> T_A2C."""
        return Pose(R=self.R @ other.R,
                    t=self.t + (self.R @ other.t[..., None])[..., 0])

    def transform(self, p3d: torch.Tensor) -> torch.Tensor:
        """Apply to (..., N, 3) points."""
        return p3d @ self.R.mT + self.t[..., None, :]

    def __matmul__(self, other):
        if isinstance(other, Pose):
            return self.compose(other)
        return self.transform(other)

    def J_transform(self, p3d_out: torch.Tensor) -> torch.Tensor:
        """Jacobian of transformed points with respect to a left-multiplied
        se3 twist: [I | -skew(p)], (..., N, 3, 6)."""
        eye = torch.eye(3, dtype=p3d_out.dtype, device=p3d_out.device)
        eye = eye.expand(p3d_out.shape + (3,))
        return torch.cat([eye, -skew_symmetric(p3d_out)], dim=-1)

    def magnitude(self):
        """(rotation angle in degrees, translation norm)."""
        trace = self.R.diagonal(dim1=-2, dim2=-1).sum(-1)
        cos = ((trace - 1.0) / 2.0).clamp(-1.0, 1.0)
        dr = torch.arccos(cos).abs() / math.pi * 180.0
        return dr, torch.linalg.vector_norm(self.t, dim=-1)
