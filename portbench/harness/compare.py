"""The numbers `correct` is decided by: what the program produced, judged
against the plain reference. Each returns a float, the worst over every
output it is given; the limits are in the workload files.

The voxel grid is judged through the event extractor's numbers: the
reference builds its own grid from the raw events, and the lower-precision
control, which leaves the grid's float32 scatter alone, could set no upper
reading for a number of its own.

Serving (per batch compared):
  score_gap_median.<side> keypoint selection and validity, for the
                    median pair: a pair's gap is the max gap of its
                    score-sorted keypoint scores (ranks are compared, not
                    identities, so a near-tie that swaps two keypoints
                    costs their gap) and, for each slot whose validity
                    differs from the reference's, how far the reference's
                    score there lies from its cut. The median pair, since
                    a round-off near-tie in the NMS (two pixels of a
                    window within ~1e-6), which the iterative NMS may
                    carry to a second keypoint, shifts one pair's ranks by
                    a score step in about 1 pair of 5,000 (PERF.md);
  kp_score_gap.<side> max |ref score map at each valid program keypoint
                    - the program's score there| (positions);
  desc_gap.<side>   max |program descriptor - ref descriptor map sampled
                    at the program's position| over valid keypoints;
  la_gap            the assignment and the matches: max |log assignment
                    - ref| over valid slots and the dustbins, the
                    reference's LightGlue run on the program's keypoints
                    and descriptors, and how far the program's matches
                    stray from the reference's assignment (for a match
                    (i, j), how far its entry lies below its row's or
                    column's best; for a row the program left unmatched
                    that the reference matches, the margin of the
                    reference's match), both in log-probability units.
Training (steps 1-3 from one state):
  loss_gap          max over the steps of |loss - ref| / |ref|;
  grad_gap          worst leaf: |norm(g) - norm(g_ref)| / max(norm(g_ref),
                    median leaf norm), g read from AdamW's first moment
                    after step 1;
  update_gap        the same of each leaf's change after step 3, for the
                    median leaf: the worst leaf's reading swings 50x from
                    seed to seed, each time another leaf (a LayerNorm
                    scale or bias) whose many near-zero gradients Adam
                    divides by their own size (PERF.md).
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable, Mapping

import torch


def worst(values: Iterable[float]) -> float:
    """The largest reading, NaN if any reading is NaN (Python's max would
    drop a NaN that is not first)."""
    values = [float(v) for v in values]
    if any(math.isnan(v) for v in values):
        return math.nan
    return max(values)


def extractor_gaps(prog: Mapping[str, torch.Tensor], ref: dict
                   ) -> Dict[str, object]:
    """prog: the program's `sparse_positions` (B, K, 3), `sparse_valid`,
    `sparse_descriptors`; ref: `reference.nets.extract`'s output.
    `score_gap_median` is a list, one gap a pair, for `median`."""
    pos, valid = prog["sparse_positions"].float(), prog["sparse_valid"]
    desc = prog["sparse_descriptors"].float()
    rvals = ref["positions"][..., 2]
    flip = valid != ref["valid"]
    score = ref["score"]
    B, H, W = score.shape
    yi = pos[..., 0].floor().long().clamp(0, H - 1)
    xi = pos[..., 1].floor().long().clamp(0, W - 1)
    at = torch.gather(score.reshape(B, H * W), 1, yi * W + xi)
    rdesc = ref["describe"](pos[..., :2])
    zero = torch.zeros((), device=pos.device)
    per_pair = torch.maximum(
        (pos[..., 2] - rvals).abs().amax(-1),
        torch.where(flip, (rvals - ref["cut"]).abs(), zero).amax(-1))
    return {
        "score_gap_median": per_pair.tolist(),
        "kp_score_gap": float(torch.where(valid, (at - pos[..., 2]).abs(),
                                          zero).max()),
        "desc_gap": float(torch.where(valid, (rdesc - desc).abs().amax(-1),
                                      zero).max()),
    }


def matcher_gaps(la: torch.Tensor, m0: torch.Tensor, ref_la: torch.Tensor,
                 ref_m0: torch.Tensor, mask0: torch.Tensor,
                 mask1: torch.Tensor) -> Dict[str, float]:
    """la, ref_la (B, N+1, M+1); m0, ref_m0 (B, N) matches (-1: none);
    mask0 (B, N), mask1 (B, M) the slots' validity."""
    la = la.float()
    true = torch.ones_like(mask0[:, :1])
    rows = torch.cat([mask0, true], 1)
    cols = torch.cat([mask1, true], 1)
    both = rows[:, :, None] & cols[:, None, :]
    zero = torch.zeros((), device=la.device)
    la_gap = torch.where(both, (la - ref_la).abs(), zero).max()

    R = ref_la[:, :-1, :-1]
    m0 = m0.long()
    j = m0.clamp(min=0)
    v = torch.gather(R, 2, j[..., None])[..., 0]
    colmax = torch.gather(R.amax(1), 1, j)
    stray = torch.maximum(R.amax(2) - v, colmax - v)
    stray = torch.where((m0 >= 0) & mask0, stray, zero)
    # rows the reference matches and the program does not
    jr = ref_m0.long().clamp(min=0)
    row2 = R.topk(2, dim=2).values[..., 1]
    col2 = torch.gather(R.topk(2, dim=1).values[:, 1], 1, jr)
    vr = torch.gather(R, 2, jr[..., None])[..., 0]
    margin = torch.minimum(vr - row2, vr - col2)
    missed = torch.where((ref_m0 >= 0) & (m0 < 0) & mask0, margin, zero)
    return {"la_gap": worst([la_gap, torch.maximum(stray, missed).max()])}


def median(values: Iterable[float]) -> float:
    """The median reading, NaN if any reading is NaN."""
    values = [float(v) for v in values]
    if any(math.isnan(v) for v in values):
        return math.nan
    return float(statistics.median(values))


def kept_leaves(ref_grads: Mapping[str, torch.Tensor]) -> Iterable[str]:
    """The leaves whose reference gradient norm is at least a thousandth of
    the median leaf's: the others move under Adam by round-off alone."""
    norms = {k: float(g.norm()) for k, g in ref_grads.items()}
    med = float(torch.tensor(sorted(norms.values())).median())
    return [k for k, n in norms.items() if n >= 1e-3 * med]


def leaf_gaps(prog: Mapping[str, torch.Tensor],
              ref: Mapping[str, torch.Tensor], keep: Iterable[str]):
    """Each leaf's |norm(prog) - norm(ref)| / max(norm(ref), median)."""
    keep = list(keep)
    rn = {k: float(ref[k].float().norm()) for k in keep}
    med = float(torch.tensor(sorted(rn.values())).median())
    return [abs(float(prog[k].float().norm()) - rn[k]) / max(rn[k], med)
            for k in keep]


def leaf_gap(prog, ref, keep) -> float:
    """The worst leaf's gap."""
    return worst(leaf_gaps(prog, ref, keep))


def median_leaf_gap(prog, ref, keep) -> float:
    """The median leaf's gap (NaN if any leaf's is)."""
    gaps = leaf_gaps(prog, ref, keep)
    if math.isnan(worst(gaps)):
        return math.nan
    return float(torch.tensor(gaps).median())
