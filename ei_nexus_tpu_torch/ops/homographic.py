"""Batched homographic sampling: the 4-point DLT solve, meshgrids and
perspective crops.

Counterpart of `ei_nexus_tpu/ops/homographic.py`, batched over a leading
dimension where the JAX package vmaps: `perspective_transform_from_points`
solves every sample's 8x8 system in one batched solve,
`extract_crops_batched` inverts every H in one batched inverse and
reads the four bilinear taps of every output pixel with one gather.
Coordinates are pixel xy with pixel centres at +0.5; samples outside the
image read zero. The solves and inverses are the `_ex` forms, which skip
the singularity check and so never wait for the device.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..geometry.se3 import to_homogeneous


def create_meshgrid(width: int, height: int, normalized: bool = True,
                    device=None) -> torch.Tensor:
    """(H, W, 2) xy grid of pixel centres: in [-1, 1] when `normalized`,
    else pixel coordinates + 0.5."""
    xs = torch.arange(width, dtype=torch.float32, device=device) + 0.5
    ys = torch.arange(height, dtype=torch.float32, device=device) + 0.5
    if normalized:
        xs = xs / width * 2 - 1
        ys = ys / height * 2 - 1
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], dim=-1)


def perspective_transform_from_points(src: torch.Tensor,
                                      dst: torch.Tensor) -> torch.Tensor:
    """Batched 4-point DLT: (..., 4, 2) src and dst -> (..., 3, 3) H with
    H @ src ~ dst and H[2, 2] = 1."""
    px, py = src[..., 0], src[..., 1]       # (..., 4)
    qx, qy = dst[..., 0], dst[..., 1]
    one, zero = torch.ones_like(px), torch.zeros_like(px)
    rx = torch.stack([px, py, one, zero, zero, zero, -px * qx, -py * qx],
                     dim=-1)                 # (..., 4, 8)
    ry = torch.stack([zero, zero, zero, px, py, one, -px * qy, -py * qy],
                     dim=-1)
    A = torch.cat([rx, ry], dim=-2)                       # (..., 8, 8)
    b = torch.cat([qx, qy], dim=-1)[..., None]            # (..., 8, 1)
    h = torch.linalg.solve_ex(A, b)[0][..., 0]
    h = torch.cat([h, torch.ones_like(h[..., :1])], dim=-1)
    return h.unflatten(-1, (3, 3))


def transform_points(H: torch.Tensor, points_xy: torch.Tensor
                     ) -> torch.Tensor:
    """(..., 3, 3) x (..., N, 2) -> (..., N, 2)."""
    w = to_homogeneous(points_xy) @ H.mT
    return w[..., :2] / (w[..., 2:] + 1e-8)


def bilinear_sample_image(image: torch.Tensor, pts_xy: torch.Tensor
                          ) -> torch.Tensor:
    """Sample images (B, H, W, C) at pixel coordinates (B, ..., 2)
    (half-pixel centres, zero outside) -> (B, ..., C): the four taps of
    every point in one gather."""
    B, Hh, Ww, C = image.shape
    x = pts_xy[..., 0] - 0.5
    y = pts_xy[..., 1] - 0.5
    x0f, y0f = torch.floor(x), torch.floor(y)
    wx = (x - x0f)[..., None]
    wy = (y - y0f)[..., None]
    x0, y0 = x0f.long(), y0f.long()
    # taps in the order (x0, y0), (x0 + 1, y0), (x0, y0 + 1), (x0 + 1, y0 + 1)
    xi = torch.stack([x0, x0 + 1, x0, x0 + 1], dim=-1)       # (B, ..., 4)
    yi = torch.stack([y0, y0, y0 + 1, y0 + 1], dim=-1)
    inb = (xi >= 0) & (xi < Ww) & (yi >= 0) & (yi < Hh)
    flat = yi.clamp(0, Hh - 1) * Ww + xi.clamp(0, Ww - 1)
    idx = flat.reshape(B, -1, 1).expand(-1, -1, C)
    taps = torch.gather(image.reshape(B, Hh * Ww, C), 1, idx)
    taps = taps.reshape(*xi.shape, C)
    taps = torch.where(inb[..., None], taps, taps.new_zeros(()))
    v00, v10, v01, v11 = taps.unbind(dim=-2)
    top = v00 * (1 - wx) + v10 * wx
    bot = v01 * (1 - wx) + v11 * wx
    return top * (1 - wy) + bot * wy


def extract_crops_batched(images: torch.Tensor, Hs: torch.Tensor,
                          crop_size: Tuple[int, int]) -> torch.Tensor:
    """Perspective crops: (B, H, W, C) images and (B, 3, 3) homographies
    mapping each source image to its crop -> (B, ch, cw, C). The crop's
    pixel grid is warped back through H^-1 into the source and sampled."""
    ch, cw = crop_size
    grid = create_meshgrid(cw, ch, normalized=False,
                           device=images.device).reshape(-1, 2)
    src = transform_points(torch.linalg.inv_ex(Hs)[0], grid)   # (B, N, 2)
    out = bilinear_sample_image(images, src)
    return out.reshape(images.shape[0], ch, cw, images.shape[-1])


def extract_crop(image: torch.Tensor, H: torch.Tensor,
                 crop_size: Tuple[int, int]) -> torch.Tensor:
    """One (H, W, C) image and its (3, 3) homography -> (ch, cw, C)."""
    return extract_crops_batched(image[None], H[None], crop_size)[0]
