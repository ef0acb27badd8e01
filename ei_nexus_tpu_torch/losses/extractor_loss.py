"""Stage-1 distillation losses: the student (event extractor) against the
frozen teacher (image extractor) on score maps, logits, descriptors and
backbone features.

Counterpart of `ei_nexus_tpu/losses/extractor_loss.py`, mode for mode and
with its quirks of the reference: masked means are sum(x * m) / max(sum(m),
1); the triplet leg of "mae+triplet" takes both sides from the student;
dual-softmax divides its mean by B a second time. Maps are NHWC; each loss
returns (loss, info) as 0-d tensors.

Under a mesh with a data group (`parallel.mesh.use_mesh`, the
data-parallel step) the normalisers are global, as XLA computes them over
the JAX mesh's global batch: a masked mean divides by the mask's count
over every rank's rows, dual-softmax by the global pair count and the
global B. Each rank's value is then the data size times its share of the
global mean, so that averaging the ranks' values, and their gradients,
gives the global loss and its gradient. The plain means are over
equal-sized local shards: their average is exact as it is.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops import depth_to_space
from ..parallel.collectives import global_sum
from ..parallel.mesh import active_mesh

Loss = Tuple[torch.Tensor, Dict[str, torch.Tensor]]


def _global_mean(total: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """total / max(count, 1); under a data group the count is the global
    one and the value the data size times this rank's share (see the
    module's docstring)."""
    mesh = active_mesh()
    if mesh is None or mesh.data_group is None:
        return total / count.clamp(min=1)
    count = global_sum(count, mesh.data_group)
    return total * mesh.data / count.clamp(min=1)


def _masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    if mask is None:
        return x.mean()
    m = mask.to(x.dtype).expand(x.shape)
    return _global_mean((x * m).sum(), m.sum())


def _plane(mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """A (B, H, W, 1) mask as (B, H, W)."""
    return mask[..., 0] if mask is not None and mask.ndim == 4 else mask


def score_loss(pred_feats: Dict, gt_feats: Dict,
               mask: Optional[torch.Tensor] = None, mode: str = "mse",
               weight: float = 1.0, use_mask: bool = True) -> Loss:
    """Full-resolution keypoint-score distillation: mse, mae (masked
    means), bce (against the teacher's score > 0, unmasked) or mse-whole
    (the teacher's score zeroed inside the mask, unmasked mean)."""
    pred = pred_feats["score"]
    gt = gt_feats["score"]
    mask = _plane(mask) if use_mask else None
    if mode == "bce":
        gt_bin = (gt > 0).to(pred.dtype)
        eps = 1e-7
        p = pred.clamp(eps, 1 - eps)
        loss = (-(gt_bin * torch.log(p) + (1 - gt_bin) * torch.log(1 - p))
                ).mean()
    elif mode == "mse-whole":
        g = torch.where(mask, torch.zeros_like(gt), gt) \
            if mask is not None else gt
        loss = ((pred - g) ** 2).mean()
    elif mode == "mse":
        loss = _masked_mean((pred - gt) ** 2, mask)
    elif mode == "mae":
        loss = _masked_mean((pred - gt).abs(), mask)
    else:
        raise NotImplementedError(f"score loss mode {mode!r}")
    loss = loss * weight
    return loss, {"extractor_keypoints_loss": loss}


def logits_loss(pred_feats: Dict, gt_feats: Dict,
                mask: Optional[torch.Tensor] = None, cell_size: int = 8,
                weight: float = 1.0) -> Loss:
    """MSE of the pixel-shuffled logits, the mask multiplied in and the
    mean over every pixel."""
    pred = depth_to_space(pred_feats["logits"], cell_size)
    gt = depth_to_space(gt_feats["logits"], cell_size)
    mask = _plane(mask)
    err = (pred - gt) ** 2
    if mask is not None:
        err = err * mask.to(err.dtype)
    loss = err.mean() * weight
    return loss, {"extractor_keypoints_loss": loss}


def descriptors_loss(pred_feats: Dict, gt_feats: Dict,
                     mask: Optional[torch.Tensor] = None, mode: str = "mae",
                     desc_type: str = "normalized", weight: float = 1.0,
                     use_mask: bool = True, triplet_margin: float = 0.2,
                     mae_weight: float = 1.0,
                     triplet_weight: float = 100.0) -> Loss:
    """Dense descriptor distillation over (B, H, W, D) maps (`desc_type`
    normalized, raw or coarse); mask (B, H, W) event occupancy. Modes:
    mse, mae, cosine_similarity, dual-softmax, triplet and mae+triplet."""
    key = {"normalized": "normalized_descriptors",
           "raw": "raw_descriptors",
           "coarse": "coarse_descriptors"}[desc_type]
    pred = pred_feats[key]
    gt = gt_feats[key]
    mask = _plane(mask) if use_mask else None
    chan_mask = None if mask is None else mask[..., None]

    if mode == "mse":
        loss = _masked_mean((pred - gt) ** 2, chan_mask)
    elif mode == "mae":
        loss = _masked_mean((pred - gt).abs(), chan_mask)
    elif mode == "cosine_similarity":
        cos = (pred * gt).sum(-1) / (
            torch.linalg.vector_norm(pred, dim=-1)
            * torch.linalg.vector_norm(gt, dim=-1)).clamp(min=1e-12)
        loss = 1.0 - _masked_mean(cos, mask)
    elif mode == "dual-softmax":
        loss = _dual_softmax_loss(pred, gt, mask)
    elif mode == "triplet":
        loss = _triplet_loss(pred, gt, mask, triplet_margin)
    elif mode == "mae+triplet":
        mae = _masked_mean((pred_feats["normalized_descriptors"]
                            - gt_feats["normalized_descriptors"]).abs(),
                           chan_mask)
        # the reference's quirk, as the JAX package keeps it: the triplet
        # leg takes BOTH sides from the student's raw descriptors, a
        # spatial self-repulsion term, not a teacher comparison
        tri = _triplet_loss(pred_feats["raw_descriptors"],
                            pred_feats["raw_descriptors"], mask,
                            triplet_margin)
        loss = mae_weight * mae + triplet_weight * tri
    else:
        raise NotImplementedError(f"descriptor loss mode {mode!r}")
    loss = loss * weight
    return loss, {"extractor_descriptor_loss": loss}


def _flat(pred: torch.Tensor, gt: torch.Tensor,
          mask: Optional[torch.Tensor]):
    """(B, HW, D) views of both maps and the (B, HW) mask as their dtype."""
    B, H, W, D = pred.shape
    m = (torch.ones(B, H * W, dtype=pred.dtype, device=pred.device)
         if mask is None else mask.reshape(B, H * W).to(pred.dtype))
    return pred.reshape(B, H * W, D), gt.reshape(B, H * W, D), m


def _dual_softmax_loss(pred: torch.Tensor, gt: torch.Tensor,
                       mask: Optional[torch.Tensor]) -> torch.Tensor:
    """-log of the dual-softmax confidence over pairs of masked pixels;
    the mean is divided by B (the global batch's) a second time, as the
    reference does."""
    mesh = active_mesh()
    B = pred.shape[0] * (1 if mesh is None else mesh.data)
    p, g, m = _flat(pred, gt, mask)
    sim = torch.einsum("bnd,bmd->bnm", p, g)
    conf = F.softmax(sim, -1) * F.softmax(sim, -2)
    pairs = (m[..., :, None] * m[..., None, :]) > 0
    ll = -torch.log(conf + 1e-8)
    return _global_mean((ll * pairs).sum(), pairs.sum()) / B


def _triplet_loss(pred: torch.Tensor, gt: torch.Tensor,
                  mask: Optional[torch.Tensor], margin: float
                  ) -> torch.Tensor:
    """In-batch triplet on student/teacher descriptor distances: for each
    pixel n, max(d(n, n) - d(n, m) + margin, 0) over the other masked
    pixels m, mean over all (B, HW, HW) entries."""
    p, g, m = _flat(pred, gt, mask)
    pair_mask = m[..., :, None] * m[..., None, :]
    d2 = ((p ** 2).sum(-1)[..., :, None] + (g ** 2).sum(-1)[..., None, :]
          - 2 * torch.einsum("bnd,bmd->bnm", p, g))
    dist = torch.sqrt(d2.clamp(min=1e-12))
    n = p.shape[1]
    diag = torch.eye(n, dtype=torch.bool, device=p.device)[None]
    zero = torch.zeros((), dtype=dist.dtype, device=dist.device)
    d_pos = torch.where(diag, dist, zero).sum(-1)[..., :, None]
    loss_map = (d_pos - dist + margin).clamp(min=0.0)
    loss_map = torch.where(diag, zero, loss_map)
    loss_map = torch.where(pair_mask > 0, loss_map, zero)
    return loss_map.mean()


def feature_loss(pred_feats: Dict, gt_feats: Dict, mode: str = "mse",
                 weight: float = 1.0) -> Loss:
    """Backbone feature distillation: mse or mae, unmasked."""
    pred = pred_feats["backbone_feats"]
    gt = gt_feats["backbone_feats"]
    if mode == "mse":
        loss = ((pred - gt) ** 2).mean()
    elif mode == "mae":
        loss = (pred - gt).abs().mean()
    else:
        raise NotImplementedError(f"feature loss mode {mode!r}")
    loss = loss * weight
    return loss, {"feature_loss": loss}
