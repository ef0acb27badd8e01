"""Detector postprocessing: logits -> probabilities -> full-res score map ->
NMS -> fixed-K keypoints.

Counterpart of `ei_nexus_tpu/ops/detector.py`, NHWC at the public
functions. Keypoint selection returns a FIXED K slots (positions (B, K, 3)
= (y+.5, x+.5, prob) and a validity mask) with the quantile-midpoint
threshold rule. Top-k ties break toward the lower flat index, as
`lax.top_k` does: selection is a stable descending sort, so the CPU and the
card pick the same slots from the same map.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from .nms_kernel import nms_rounds, window_max


def logits_to_prob(logits: torch.Tensor, channel_axis: int = -1
                   ) -> torch.Tensor:
    """Softmax over cells (or sigmoid for single-channel heads)."""
    if logits.shape[channel_axis] == 1:
        return torch.sigmoid(logits)
    return torch.softmax(logits, dim=channel_axis)


def depth_to_space(prob: torch.Tensor, cell_size: int = 8) -> torch.Tensor:
    """(B, h, w, cell^2+1) cell probabilities -> (B, H, W) full-res map.

    Drops the dustbin channel and pixel-shuffles; channel c = i*cell + j maps
    to spatial offset (i, j) (F.pixel_shuffle convention)."""
    if cell_size == 1:
        assert prob.shape[-1] == 1
        return prob[..., 0]
    assert prob.shape[-1] == cell_size * cell_size + 1
    B, h, w, _ = prob.shape
    p = prob[..., : cell_size * cell_size]
    p = p.reshape(B, h, w, cell_size, cell_size).permute(0, 1, 3, 2, 4)
    return p.reshape(B, h * cell_size, w * cell_size)


def space_to_depth(score: torch.Tensor, cell_size: int = 8) -> torch.Tensor:
    """(B, H, W) full-res map -> (B, h, w, cell^2+1) cells, the inverse of
    `depth_to_space`, with a dustbin channel 1 - sum(cell) clamped at 0."""
    B, H, W = score.shape
    h, w = H // cell_size, W // cell_size
    p = score.reshape(B, h, cell_size, w, cell_size).permute(0, 1, 3, 2, 4)
    p = p.reshape(B, h, w, cell_size * cell_size)
    dustbin = (1.0 - p.sum(dim=-1, keepdim=True)).clamp(min=0.0)
    return torch.cat([p, dustbin], dim=-1)


def remove_border_scores(score: torch.Tensor, border: int) -> torch.Tensor:
    """Zero the outer `border` pixels of a (B, H, W) score map."""
    if border <= 0:
        return score
    H, W = score.shape[-2], score.shape[-1]
    ys = torch.arange(H, device=score.device)
    xs = torch.arange(W, device=score.device)
    keep = (((ys >= border) & (ys < H - border))[:, None]
            & ((xs >= border) & (xs < W - border))[None, :])
    return torch.where(keep, score, torch.zeros_like(score))


def nms(score: torch.Tensor, radius: int, max_iter: int = 8,
        impl: str = "auto") -> torch.Tensor:
    """Iterative local-maximum NMS on a (B, H, W) score map.

    impl: "auto" takes the NMS kernel with min(max_iter, 4) fixed rounds on
    a CUDA tensor and the loop run to convergence (at most `max_iter`
    rounds) on a CPU tensor; "pallas" always takes the kernel path
    (`nms_rounds`: the CUDA kernel, or its plain version on the CPU);
    "xla" always runs to convergence."""
    if radius <= 0:
        return score
    if impl == "auto":
        impl = "pallas" if score.device.type == "cuda" else "xla"
    if impl == "pallas":
        return nms_rounds(score, radius, min(max_iter, 4))
    if impl != "xla":
        raise ValueError(f"unknown nms impl {impl!r}")

    def step(x):
        is_max = (x == window_max(x, radius)) & (x > 0)
        suppressed = window_max(is_max.to(x.dtype), radius) > 0
        return (torch.where(suppressed & ~is_max, torch.zeros_like(x), x),
                int(is_max.sum()))

    # the count of maxima over the whole batch decides convergence
    x, count = step(score)
    prev, i = -1, 1
    while count != prev and i < max_iter:
        prev = count
        x, count = step(x)
        i += 1
    return x


def smooth_score_mask(mask: torch.Tensor) -> torch.Tensor:
    """3x3 dilation of a (B, H, W) boolean event-occupancy mask."""
    return window_max(mask.to(torch.float32), 1) > 0


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis, ties to the lower index (lax.top_k)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def select_topk_keypoints(
    nms_score: torch.Tensor,
    k: int,
    prob_thresh: float = 1.0,
    ordering: str = "yx",
    min_distance: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fixed-K keypoint extraction from an NMS'd (B, H, W) score map.

    Returns (positions (B, K, 3), valid (B, K)): positions are (y+0.5,
    x+0.5, prob) in `yx` ordering (or (x+0.5, y+0.5, prob) for `xy`),
    sorted by descending score; `valid` marks slots whose probability
    survives `prob > min(prob_thresh, topk_quantile_midpoint)`.

    `min_distance` > 1 first reduces the map to the per-block top-2 over
    `min_distance`-sized blocks (exact when at most two mutually
    unsuppressed pixels share a block; see the JAX counterpart)."""
    assert ordering in ("yx", "xy")
    B, H, W = nms_score.shape
    flat = nms_score.reshape(B, H * W)
    b = int(min_distance)
    G = (-(-H // b) * -(-W // b)) if b > 1 else 0
    if k >= H * W:
        vals, idx = _top_k(flat, H * W)
        thresh = torch.zeros(B, 1, dtype=nms_score.dtype,
                             device=nms_score.device)
        vals = F.pad(vals, (0, k - H * W))
        idx = F.pad(idx, (0, k - H * W))
    elif b > 1 and G > k:
        # per-block top-2 candidate reduction
        Hp, Wp = -(-H // b) * b, -(-W // b) * b
        x = F.pad(nms_score, (0, Wp - W, 0, Hp - H))
        gy, gx = Hp // b, Wp // b
        blk = x.reshape(B, gy, b, gx, b).permute(0, 1, 3, 2, 4)
        blk = blk.reshape(B, gy * gx, b * b)
        bv2, bl2 = _top_k(blk, 2)                    # (B, G, 2)
        bval = bv2.reshape(B, 2 * G)
        bloc = bl2.reshape(B, 2 * G)                 # in-block flat index
        vals_p1, ci = _top_k(bval, k + 1)            # (B, k+1) candidates
        loc = torch.gather(bloc, 1, ci)
        gidx = ci // 2                               # candidate -> block id
        by, bx = gidx // gx, gidx % gx
        idx_p1 = (by * b + loc // b) * W + (bx * b + loc % b)
        vals, idx = vals_p1[:, :k], idx_p1[:, :k]
        thresh = (vals_p1[:, k - 1:k] + vals_p1[:, k:k + 1]) / 2.0
    else:
        vals_p1, idx_p1 = _top_k(flat, k + 1)
        vals, idx = vals_p1[:, :k], idx_p1[:, :k]
        # torch.quantile((HW-k)/HW, midpoint) == mean of k-th/(k+1)-th largest
        thresh = (vals_p1[:, k - 1:k] + vals_p1[:, k:k + 1]) / 2.0
    thresh = torch.clamp(thresh, max=prob_thresh)
    valid = vals > thresh

    ys = (idx // W).to(nms_score.dtype) + 0.5
    xs = (idx % W).to(nms_score.dtype) + 0.5
    cols = [ys, xs, vals] if ordering == "yx" else [xs, ys, vals]
    return torch.stack(cols, dim=-1), valid


def dense_positions(score: torch.Tensor, ordering: str = "yx"
                    ) -> torch.Tensor:
    """All pixel positions with their scores: (B, H*W, 3) in row-major
    order."""
    B, H, W = score.shape
    ys, xs = torch.meshgrid(
        torch.arange(H, dtype=score.dtype, device=score.device),
        torch.arange(W, dtype=score.dtype, device=score.device),
        indexing="ij")
    ys = (ys + 0.5).reshape(-1)
    xs = (xs + 0.5).reshape(-1)
    grid = torch.stack([ys, xs] if ordering == "yx" else [xs, ys], dim=-1)
    grid = grid[None].expand(B, H * W, 2)
    return torch.cat([grid, score.reshape(B, H * W, 1)], dim=-1)
