"""PointNet++ building blocks: set abstraction (single- and multi-scale
grouping), feature propagation, farthest-point sampling, ball query.

Counterpart of `ei_nexus_tpu/models/pointnet.py` (the reference's
`core/modules/net/pointnet.py`, dormant there: no extractor uses it), with
fixed shapes. Ties in the top-k selections go to the lower index, as
`lax.top_k` breaks them (`ops/detector.py:_top_k`), and the argmax of the
farthest-point sampling to the first. The layers keep flax's names
(`mlp_{i}`, `scale{s}_mlp_{i}`), so `port_jax.load_jax_variables`
carries the JAX modules' weights across; unlike flax, a module is told
the width of the features it takes (0 for none).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.detector import _top_k
from .layers import Linear


def square_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., N, 3) x (..., M, 3) -> (..., N, M) squared distances."""
    return ((a ** 2).sum(-1)[..., :, None] + (b ** 2).sum(-1)[..., None, :]
            - 2 * torch.einsum("...nd,...md->...nm", a, b))


def farthest_point_sample(xyz: torch.Tensor, n_samples: int,
                          mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Iterative farthest-point sampling: (N, 3) -> (n_samples,) indices,
    starting at the first valid point; masked points are never taken."""
    if mask is None:
        mask = torch.ones(xyz.shape[0], dtype=torch.bool, device=xyz.device)
    big = torch.full((), 1e10, dtype=xyz.dtype, device=xyz.device)
    dist = torch.where(mask, big, -big)
    last = mask.to(torch.uint8).argmax()
    out = [last]
    for _ in range(n_samples - 1):
        d = ((xyz - xyz[last]) ** 2).sum(-1)
        dist = torch.minimum(dist, torch.where(mask, d, -big))
        last = torch.where(mask, dist, -big).argmax()
        out.append(last)
    return torch.stack(out)


def ball_query(xyz: torch.Tensor, centers: torch.Tensor, radius: float,
               n_neighbors: int, mask: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, 3), (S, 3) -> neighbour indices (S, K) and validity (S, K):
    the nearest points inside the radius first; slots beyond them repeat
    the nearest neighbour (PointNet++'s grouping convention)."""
    d2 = square_distance(centers, xyz)                     # (S, N)
    if mask is not None:
        d2 = torch.where(mask[None, :], d2, torch.inf)
    in_ball = d2 <= radius ** 2
    key = torch.where(in_ball, d2, d2 + 1e9)
    _, idx = _top_k(-key, n_neighbors)                    # (S, K)
    valid = torch.gather(in_ball, 1, idx)
    idx = torch.where(valid, idx, idx[:, :1])
    return idx, valid


def _mlp(module: nn.Module, prefix: str, width_in: int,
         widths: Sequence[int]) -> None:
    for i, width in enumerate(widths):
        module.add_module(f"{prefix}mlp_{i}", Linear(width_in, width))
        width_in = width


def _run_mlp(module: nn.Module, prefix: str, n: int, h: torch.Tensor,
             dtype) -> torch.Tensor:
    h = h.to(dtype)
    for i in range(n):
        h = F.relu(getattr(module, f"{prefix}mlp_{i}")(h).to(dtype))
    return h


def _pool(h: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Max over each group's valid neighbours; 0 for a group with none."""
    h = torch.where(valid[..., None], h, -torch.inf).amax(dim=1)
    return torch.where(torch.isfinite(h), h, torch.zeros_like(h))


def _group(xyz, feats, centers, idx):
    grouped = xyz[idx] - centers[:, None, :]               # (S, K, 3)
    if feats is not None:
        grouped = torch.cat([grouped, feats[idx]], dim=-1)
    return grouped


class PointNetSAModule(nn.Module):
    """Set abstraction: farthest-point centres -> ball-query groups ->
    shared MLP -> max pool (the reference's PointNet_SA_Module)."""

    def __init__(self, n_centers: int, radius: float, n_neighbors: int,
                 mlp: Sequence[int], in_channels: int = 0,
                 dtype=torch.float32):
        super().__init__()
        self.n_centers, self.radius = n_centers, radius
        self.n_neighbors, self.n_mlp, self.dtype = n_neighbors, len(mlp), dtype
        _mlp(self, "", 3 + in_channels, mlp)

    def forward(self, xyz: torch.Tensor,
                feats: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None):
        """xyz (N, 3), feats (N, C) -> (centres (S, 3), out (S, mlp[-1]))."""
        centers = xyz[farthest_point_sample(xyz, self.n_centers, mask)]
        idx, valid = ball_query(xyz, centers, self.radius, self.n_neighbors,
                                mask)
        h = _run_mlp(self, "", self.n_mlp,
                     _group(xyz, feats, centers, idx), self.dtype)
        return centers, _pool(h, valid)


class PointNetSAModuleMSG(nn.Module):
    """Multi-scale grouping set abstraction (the reference's
    PointNet_SA_Module_MSG): one group and MLP a radius, concatenated."""

    def __init__(self, n_centers: int, radii: Sequence[float],
                 n_neighbors: Sequence[int], mlps: Sequence[Sequence[int]],
                 in_channels: int = 0, dtype=torch.float32):
        super().__init__()
        self.n_centers, self.radii = n_centers, tuple(radii)
        self.n_neighbors = tuple(n_neighbors)
        self.n_mlp = tuple(len(m) for m in mlps)
        self.dtype = dtype
        for si, mlp in enumerate(mlps):
            _mlp(self, f"scale{si}_", 3 + in_channels, mlp)

    def forward(self, xyz: torch.Tensor,
                feats: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None):
        centers = xyz[farthest_point_sample(xyz, self.n_centers, mask)]
        outs = []
        for si, (radius, k) in enumerate(zip(self.radii, self.n_neighbors)):
            idx, valid = ball_query(xyz, centers, radius, k, mask)
            h = _run_mlp(self, f"scale{si}_", self.n_mlp[si],
                         _group(xyz, feats, centers, idx), self.dtype)
            outs.append(_pool(h, valid))
        return centers, torch.cat(outs, dim=-1)


class PointNetFPModule(nn.Module):
    """Feature propagation: three-nearest-neighbour inverse-distance
    interpolation, then an MLP (the reference's PointNet_FP_Module).
    `in_channels` is the width of the concatenated (destination, source)
    features."""

    def __init__(self, mlp: Sequence[int], in_channels: int,
                 dtype=torch.float32):
        super().__init__()
        self.n_mlp, self.dtype = len(mlp), dtype
        _mlp(self, "", in_channels, mlp)

    def forward(self, xyz_dst: torch.Tensor, xyz_src: torch.Tensor,
                feats_dst: Optional[torch.Tensor],
                feats_src: torch.Tensor) -> torch.Tensor:
        """xyz_dst (N, 3), xyz_src (S, 3), feats_src (S, C) -> (N, out)."""
        top, idx = _top_k(-square_distance(xyz_dst, xyz_src), 3)
        w = 1.0 / (-top).clamp(min=1e-8)
        w = w / w.sum(-1, keepdim=True)
        interp = (feats_src[idx] * w[..., None]).sum(dim=1)
        h = interp if feats_dst is None else torch.cat([feats_dst, interp],
                                                       dim=-1)
        return _run_mlp(self, "", self.n_mlp, h, self.dtype)
