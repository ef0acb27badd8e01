"""Matcher losses: the MNN NLL and LightGlue's deep-supervision NLL.

Counterpart of `ei_nexus_tpu/losses/matcher_loss.py` (`mnn_loss`,
`lightglue_loss`, `nll_weights_from_gt`, `_weighted_nll`,
`_bce_with_logits`), over the MNN matcher's `similarity` and LightGlue's
training outputs `all_log_assignments` and `confidence_logits*`.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch


def mnn_loss(pred_match: Dict, gt_match: Dict, weight: float = 1.0
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """NLL of the dual log-softmax of "2 - chordal distance" scores at the
    GT-assigned pairs. pred_match: `similarity` (B, N, M); gt_match:
    `assignment` (B, N, M). Returns (loss, info) as 0-d tensors."""
    sim = pred_match["similarity"]
    assignment = gt_match["assignment"].to(sim.dtype)
    scores = 2.0 - torch.sqrt((2.0 * (1.0 - sim)).clamp(min=1e-6))
    prob0 = torch.log_softmax(scores, dim=2)
    prob1 = torch.log_softmax(scores, dim=1)
    num = assignment.sum(dim=(1, 2)).clamp(min=1.0)
    nll0 = (prob0 * assignment).sum(dim=(1, 2)) / num
    nll1 = (prob1 * assignment).sum(dim=(1, 2)) / num
    nll = -(nll0 + nll1) / 2.0
    loss = nll.mean() * weight
    return loss, {
        "matcher_n_pair_nll": loss,
        "matcher_total": loss,
        "matcher_num_matchable": num.mean(),
    }


def nll_weights_from_gt(la_shape, gt_matches0: torch.Tensor,
                        gt_matches1: torch.Tensor,
                        gt_assignment: torch.Tensor) -> torch.Tensor:
    """(B, N+1, M+1) weights from GT labels: positives in the core,
    unmatched (-1) in the dustbin row and column, ignored (-2) nowhere."""
    B, Np1, Mp1 = la_shape
    N, M = Np1 - 1, Mp1 - 1
    w = torch.zeros(B, Np1, Mp1, dtype=torch.float32,
                    device=gt_assignment.device)
    w[:, :N, :M] = gt_assignment.float()
    w[:, :N, -1] = (gt_matches0 == -1).float()
    w[:, -1, :M] = (gt_matches1 == -1).float()
    return w


def _weighted_nll(log_assignment: torch.Tensor, weights: torch.Tensor,
                  nll_balancing: float):
    """Positive/negative-balanced NLL of one layer's assignment."""
    N, M = log_assignment.shape[-2] - 1, log_assignment.shape[-1] - 1
    loss_sc = log_assignment * weights
    num_neg0 = weights[:, :N, -1].sum(-1).clamp(min=1.0)
    num_neg1 = weights[:, -1, :M].sum(-1).clamp(min=1.0)
    num_pos = weights[:, :N, :M].sum((-1, -2)).clamp(min=1.0)
    nll_pos = -loss_sc[:, :N, :M].sum((-1, -2)) / num_pos
    nll_neg0 = -loss_sc[:, :N, -1].sum(-1)
    nll_neg1 = -loss_sc[:, -1, :M].sum(-1)
    nll_neg = (nll_neg0 + nll_neg1) / (num_neg0 + num_neg1)
    nll = nll_balancing * nll_pos + (1.0 - nll_balancing) * nll_neg
    return nll, nll_pos, nll_neg, num_pos, (num_neg0 + num_neg1) / 2.0


def _bce_with_logits(logits: torch.Tensor, targets: torch.Tensor
                     ) -> torch.Tensor:
    return (logits.clamp(min=0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))


def lightglue_loss(pred: Dict, gt: Dict, gamma: float = 1.0,
                   nll_balancing: float = 0.5, training: bool = True
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Deep-supervision NLL over all layers plus the token-confidence BCE.

    pred: `all_log_assignments` (B, L, N+1, M+1) and `confidence_logits0/1`
    (B, L-1, N|M); gt: matches0, matches1, assignment. Layer i weighs
    gamma^(L-1-i) (the last layer 1), normalised by the weights' sum; the
    confidence targets are each layer's argmax agreement with the last.
    Returns (loss, info) as 0-d tensors (no host synchronisation)."""
    all_la = pred["all_log_assignments"]
    B, L = all_la.shape[0], all_la.shape[1]
    final_la = all_la[:, -1]
    weights = nll_weights_from_gt(final_la.shape, gt["matches0"],
                                  gt["matches1"], gt["assignment"])

    nll_final, nll_pos, nll_neg, num_pos, num_neg = _weighted_nll(
        final_la, weights, nll_balancing)
    total = nll_final
    sum_weights = 1.0
    confidence = final_la.new_zeros(B)

    fin_max0 = final_la[:, :-1, :].argmax(dim=-1)
    fin_max1 = final_la[:, :, :-1].argmax(dim=-2)

    for i in range(L - 1):
        la_i = all_la[:, i]
        nll_i = _weighted_nll(la_i, weights, nll_balancing)[0]
        w_i = gamma ** (L - i - 1) if gamma > 0.0 else float(i + 1)
        sum_weights += w_i
        total = total + nll_i * w_i

        correct0 = la_i[:, :-1, :].argmax(dim=-1) == fin_max0
        correct1 = la_i[:, :, :-1].argmax(dim=-2) == fin_max1
        logit0 = pred["confidence_logits0"][:, i]
        logit1 = pred["confidence_logits1"][:, i]
        bce0 = _bce_with_logits(
            logit0, correct0[:, :logit0.shape[1]].to(logit0.dtype)).mean(-1)
        bce1 = _bce_with_logits(
            logit1, correct1[:, :logit1.shape[1]].to(logit1.dtype)).mean(-1)
        confidence = confidence + (bce0 + bce1) / 2.0 / (L - 1)

    total = total / sum_weights
    if training:
        total = total + confidence

    row_norm = torch.exp(final_la)[:, :-1].sum(dim=2).mean(dim=1)
    loss = total.mean()
    return loss, {
        "matcher_total": loss,
        "matcher_last": nll_final.mean(),
        "matcher_nll_positive": nll_pos.mean(),
        "matcher_nll_negtive": nll_neg.mean(),
        "matcher_num_matchable": num_pos.mean(),
        "matcher_num_unmatchable": num_neg.mean(),
        "matcher_confidence": confidence.mean(),
        "matcher_row_norm": row_norm.mean(),
    }
