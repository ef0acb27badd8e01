"""Batched pinhole camera with radial-tangential distortion.

Counterpart of `ei_nexus_tpu/geometry/camera.py`: a fixed 4-term
distortion slot (k1, k2, p1, p2, zero-padded); pixel coordinates are
(x, y); `size` is (width, height).
"""

from __future__ import annotations

import dataclasses

import torch

from ..device import resolve_device
from .se3 import to_homogeneous


@dataclasses.dataclass(frozen=True)
class Camera:
    size: torch.Tensor  # (..., 2) width, height
    f: torch.Tensor     # (..., 2) fx, fy
    c: torch.Tensor     # (..., 2) cx, cy
    dist: torch.Tensor  # (..., 4) k1, k2, p1, p2
    eps: float = 1e-4

    @classmethod
    def from_calibration_matrix(cls, K, size=None) -> "Camera":
        """From a (..., 3, 3) intrinsics matrix; without `size`, 2*c stands
        in for the image size (as the JAX package does)."""
        K = torch.as_tensor(K)
        f = torch.stack([K[..., 0, 0], K[..., 1, 1]], dim=-1)
        c = torch.stack([K[..., 0, 2], K[..., 1, 2]], dim=-1)
        if size is None:
            size = 2.0 * c
        else:
            size = torch.as_tensor(size, dtype=K.dtype,
                                   device=K.device).expand(c.shape)
        dist = K.new_zeros(c.shape[:-1] + (4,))
        return cls(size=size, f=f, c=c, dist=dist)

    @classmethod
    def from_params(cls, width, height, fx, fy, cx, cy, dist=None,
                    device=None) -> "Camera":
        """From scalars or arrays of them (float32) on `device` (the card
        unless the caller names another); `dist` up to four terms,
        zero-padded."""
        device = resolve_device(device)
        def f32(*xs):
            return torch.stack([torch.as_tensor(x, dtype=torch.float32,
                                                device=device) for x in xs],
                               dim=-1)
        size, f, c = f32(width, height), f32(fx, fy), f32(cx, cy)
        if dist is None:
            d = f.new_zeros(f.shape[:-1] + (4,))
        else:
            d = torch.as_tensor(dist, dtype=torch.float32, device=device)
            if d.shape[-1] < 4:
                d = torch.cat([d, d.new_zeros(d.shape[:-1]
                                              + (4 - d.shape[-1],))], -1)
        return cls(size=size, f=f, c=c, dist=d)

    @property
    def shape(self):
        return self.f.shape[:-1]

    def scale(self, scales) -> "Camera":
        """The camera of the image resized by `scales` (a scalar or (sx,
        sy))."""
        s = torch.as_tensor(scales, dtype=self.f.dtype,
                            device=self.f.device).expand(self.f.shape)
        return Camera(size=self.size * s, f=self.f * s, c=self.c * s,
                      dist=self.dist, eps=self.eps)

    def crop(self, left_top, size) -> "Camera":
        """The camera of the crop at `left_top` (x, y) of `size` (w, h)."""
        lt = torch.as_tensor(left_top, dtype=self.f.dtype,
                             device=self.f.device)
        new_size = torch.as_tensor(size, dtype=self.f.dtype,
                                   device=self.f.device).expand(
                                       self.size.shape)
        return Camera(size=new_size, f=self.f, c=self.c - lt,
                      dist=self.dist, eps=self.eps)

    def calibration_matrix(self) -> torch.Tensor:
        z = torch.zeros_like(self.f[..., 0])
        o = torch.ones_like(z)
        rows = [self.f[..., 0], z, self.c[..., 0],
                z, self.f[..., 1], self.c[..., 1],
                z, z, o]
        return torch.stack(rows, dim=-1).unflatten(-1, (3, 3))

    def in_image(self, p2d: torch.Tensor) -> torch.Tensor:
        """(..., N, 2) -> (..., N) bool, inside [0, size - 1]."""
        size = self.size[..., None, :]
        return ((p2d >= 0) & (p2d <= size - 1)).all(dim=-1)

    def project(self, p3d: torch.Tensor):
        """Perspective divide: ((..., N, 2), (..., N) valid)."""
        z = p3d[..., -1]
        valid = z > self.eps
        z = z.clamp(min=self.eps)
        return p3d[..., :-1] / z[..., None], valid

    def J_project(self, p3d: torch.Tensor) -> torch.Tensor:
        """Jacobian of the perspective divide, (..., N, 2, 3)."""
        x, y, z = p3d[..., 0], p3d[..., 1], p3d[..., 2]
        z = z.clamp(min=self.eps)
        zero = torch.zeros_like(z)
        J = torch.stack([1 / z, zero, -x / z ** 2,
                         zero, 1 / z, -y / z ** 2], dim=-1)
        return J.unflatten(-1, (2, 3))

    def distort(self, pts: torch.Tensor):
        """Radial-tangential distortion of normalised coordinates; valid
        flags points inside the radial polynomial's monotonic region."""
        d = self.dist[..., None, :]
        k1, k2 = d[..., 0:1], d[..., 1:2]
        p12 = d[..., 2:4]
        r2 = (pts ** 2).sum(dim=-1, keepdim=True)
        radial = k1 * r2 + k2 * r2 ** 2
        undist = pts + pts * radial
        uv = pts.prod(dim=-1, keepdim=True)
        undist = undist + 2 * p12 * uv + p12.flip(-1) * (r2 + 2 * pts ** 2)
        limited = (((k2 > 0) & ((9 * k1 ** 2 - 20 * k2) > 0))
                   | ((k2 <= 0) & (k1 > 0)))
        disc = (9 * k1 ** 2 - 20 * k2).clamp(min=0.0)
        safe_k2 = torch.where(k2.abs() > 1e-12, k2, torch.ones_like(k2))
        safe_k1 = torch.where(k1.abs() > 1e-12, k1, torch.ones_like(k1))
        limit = torch.where(k2 > 0, (disc.sqrt() - 3 * k1) / (10 * safe_k2),
                            1 / (3 * safe_k1)).abs()
        valid = (~limited | (r2 < limit)).squeeze(-1)
        return undist, valid

    def denormalize(self, p2d: torch.Tensor) -> torch.Tensor:
        return p2d * self.f[..., None, :] + self.c[..., None, :]

    def normalize(self, p2d: torch.Tensor) -> torch.Tensor:
        return (p2d - self.c[..., None, :]) / self.f[..., None, :]

    def cam2image(self, p3d: torch.Tensor):
        """(..., N, 3) camera-frame points -> ((..., N, 2) px, valid)."""
        p2d, visible = self.project(p3d)
        p2d, dist_ok = self.distort(p2d)
        p2d = self.denormalize(p2d)
        return p2d, visible & dist_ok & self.in_image(p2d)

    def image2cam(self, p2d: torch.Tensor) -> torch.Tensor:
        """(..., N, 2) pixels -> (..., N, 3) rays with z = 1."""
        return to_homogeneous(self.normalize(p2d))
