"""Mutual-nearest-neighbour descriptor matcher.

Counterpart of `ei_nexus_tpu/models/mnn.py`: the similarity einsum
`bnd,bmd->bnm`, optional ratio and distance tests on the two best
neighbours, the mutual check, and the (N+1, M+1) log-assignment of the
dual log-softmax with zero dustbins, batched in static shapes. Invalid
(padded) slots are masked out of the similarity before matching.

Ties go to the lower index on every device, as `jnp.argmax` and
`lax.top_k` break them (`_first_argmax`).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

_NEG_INF = -1e9


def _first_argmax(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(max, index of its first occurrence) along the last axis, NaN
    counted as the largest value, as `jnp.argmax` does."""
    m = x.amax(dim=-1, keepdim=True)
    hit = (x == m) | torch.isnan(x)
    ar = torch.arange(x.shape[-1], device=x.device)
    idx = torch.where(hit, ar, x.shape[-1]).amin(dim=-1)
    return m[..., 0], idx


def _find_nn(sim: torch.Tensor, ratio_thresh: Optional[float],
             distance_thresh: Optional[float]) -> torch.Tensor:
    """Best-match indices along the last axis with optional ratio and
    distance tests. sim: (..., N, M) -> (..., N) int32, -1 where a test
    fails."""
    best_sim, best = _first_argmax(sim)
    best_dist = 2 * (1 - best_sim)
    if ratio_thresh:
        # the second neighbour, as lax.top_k(sim, 2) gives it
        rest = sim.scatter(-1, best[..., None], float("-inf"))
        second_dist = 2 * (1 - _first_argmax(rest)[0])
        mask = best_dist <= (ratio_thresh ** 2) * second_dist
    else:
        mask = torch.ones_like(best, dtype=torch.bool)
    if distance_thresh:
        mask = mask & (best_dist <= distance_thresh ** 2)
    return torch.where(mask, best, -1).to(torch.int32)


def _mutual_check(m0: torch.Tensor, m1: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keep only the matches that agree in both directions."""
    inds0 = torch.arange(m0.shape[-1], device=m0.device)
    inds1 = torch.arange(m1.shape[-1], device=m1.device)
    loop0 = torch.gather(m1, -1, m0.clamp(min=0).long())
    loop1 = torch.gather(m0, -1, m1.clamp(min=0).long())
    m0_new = torch.where((m0 > -1) & (inds0 == loop0), m0, -1)
    m1_new = torch.where((m1 > -1) & (inds1 == loop1), m1, -1)
    return m0_new, m1_new


def mnn_match(feats0: Dict[str, torch.Tensor],
              feats1: Dict[str, torch.Tensor],
              ratio_thresh: Optional[float] = None,
              distance_thresh: Optional[float] = None,
              mutual_check: bool = True) -> Dict[str, torch.Tensor]:
    """Match two fixed-K feature dicts.

    feats* hold `sparse_descriptors` (B, K, D) and optionally
    `sparse_valid` (B, K). Returns matches0/1 (int32, -1 where unmatched
    or invalid), matching_scores0/1 (float32 0/1), the similarity and the
    (B, N+1, M+1) log_assignment, in the descriptors' dtype."""
    desc0 = feats0["sparse_descriptors"]
    desc1 = feats1["sparse_descriptors"]
    valid0 = feats0.get("sparse_valid")
    valid1 = feats1.get("sparse_valid")

    sim = torch.einsum("bnd,bmd->bnm", desc0, desc1)
    sim_m = sim
    if valid0 is not None:
        sim_m = torch.where(valid0[..., :, None], sim_m, _NEG_INF)
    if valid1 is not None:
        sim_m = torch.where(valid1[..., None, :], sim_m, _NEG_INF)

    matches0 = _find_nn(sim_m, ratio_thresh, distance_thresh)
    matches1 = _find_nn(sim_m.transpose(-1, -2), ratio_thresh,
                        distance_thresh)
    if mutual_check:
        matches0, matches1 = _mutual_check(matches0, matches1)
    if valid0 is not None:
        matches0 = torch.where(valid0, matches0, -1)
    if valid1 is not None:
        matches1 = torch.where(valid1, matches1, -1)

    B, N, M = sim.shape
    la = sim.new_zeros(B, N + 1, M + 1)
    la[:, :N, :M] = (torch.log_softmax(sim, dim=-1)
                     + torch.log_softmax(sim, dim=-2))
    return {
        "matches0": matches0,
        "matches1": matches1,
        "matching_scores0": (matches0 > -1).float(),
        "matching_scores1": (matches1 > -1).float(),
        "similarity": sim,
        "log_assignment": la,
    }


def gather_matched_keypoints(kpts0: torch.Tensor, kpts1: torch.Tensor,
                             matches0: torch.Tensor):
    """Pair up matched keypoints in static shape: (mkpts0 (B, N, C),
    mkpts1 (B, N, C), match_mask (B, N)); slot i holds (kpts0[i],
    kpts1[matches0[i]]) where matched."""
    match_mask = matches0 > -1
    idx = matches0.clamp(min=0).long()[..., None].expand(
        -1, -1, kpts1.shape[-1])
    return kpts0, torch.gather(kpts1, -2, idx), match_mask
