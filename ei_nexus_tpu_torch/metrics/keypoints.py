"""Keypoint metrics: map-level detection statistics, repeatability under a
known homography and the descriptor distance at valid correspondences.

A copy of `ei_nexus_tpu/metrics/keypoints.py`: host-side numpy, run per
pair at evaluation time; inputs are the fixed-K keypoints with their
validity masks applied by the caller.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def _warp_xy(points_xy: np.ndarray, H: np.ndarray) -> np.ndarray:
    """(N, 2) xy points through a 3x3 homography."""
    pts = np.concatenate(
        [points_xy, np.ones((len(points_xy), 1), points_xy.dtype)], axis=1)
    w = pts @ H.T
    return w[:, :2] / w[:, 2:]


def _keep_in_frame(points_xy: np.ndarray, H: np.ndarray,
                   img_shape: Tuple[int, int]):
    """Keep points whose warp by H lands inside img_shape (H rows, W cols)
    (reference util.py keep_true_points)."""
    if len(points_xy) == 0:
        return points_xy, np.zeros(0, bool)
    w = _warp_xy(points_xy, H)
    mask = ((w[:, 0] >= 0) & (w[:, 0] < img_shape[1])
            & (w[:, 1] >= 0) & (w[:, 1] < img_shape[0]))
    return points_xy[mask], mask


def _to_xy(points: np.ndarray, ordering: str) -> np.ndarray:
    pts = np.asarray(points, np.float64)[:, :2]
    return pts[:, ::-1] if ordering == "yx" else pts


def detection_metric(pred_score, gt_score, pred_nms, gt_nms, event_mask
                     ) -> Dict[str, float]:
    """Map-level overlap/probability statistics
    (reference keypoints_metrics.py:10)."""
    pred_score = np.asarray(pred_score)
    gt_score = np.asarray(gt_score)
    pred_k = np.asarray(pred_nms) > 0
    gt_k = np.asarray(gt_nms) > 0
    em = np.asarray(event_mask).astype(bool)
    if pred_score.ndim == 4:
        pred_score = pred_score.squeeze(1)
    if gt_score.ndim == 4:
        gt_score = gt_score.squeeze(1)
    if em.ndim == 4:
        em = em.squeeze(1)

    min_kpts = min(pred_k.sum(), gt_k.sum())
    rep = float((pred_k & gt_k).sum() / min_kpts) if min_kpts > 0 else 0.0

    def _mean(x, m):
        return float(x[m].mean()) if m.sum() else 0.0

    return {
        "repeatability": rep,
        "pred_avg_probs": _mean(pred_score, em),
        "pred_avg_pred_probs": _mean(pred_score, pred_k),
        "pred_avg_gt_probs": _mean(pred_score, gt_k),
        "gt_avg_probs": _mean(gt_score, em),
        "gt_avg_gt_probs": _mean(gt_score, gt_k),
        "gt_avg_pred_probs": _mean(gt_score, pred_k),
    }


class Repeatability:
    """Two-view keypoint repeatability under a known homography
    (reference Repeatability:54)."""

    def __init__(self, name: str, distance_thresh: float = 3,
                 ordering: str = "xy") -> None:
        assert ordering in ("xy", "yx")
        self.metric_name = name
        self.distance_thresh = distance_thresh
        self.ordering = ordering

    def update_one(self, points1, points2, img1_shape, img2_shape,
                   homography) -> Dict[str, float]:
        p1 = _to_xy(np.asarray(points1), self.ordering)
        p2 = _to_xy(np.asarray(points2), self.ordering)
        H = np.asarray(homography, np.float64)

        p2, _ = _keep_in_frame(p2, np.linalg.inv(H), img1_shape)
        p1, _ = _keep_in_frame(p1, H, img2_shape)
        warped1 = _warp_xy(p1, H)

        n1, n2 = len(warped1), len(p2)
        out: Dict[str, float] = {}
        count1 = count2 = 0
        if n1 and n2:
            norm = np.linalg.norm(warped1[:, None] - p2[None], axis=2)
            count1 = int((norm.min(axis=0) <= self.distance_thresh).sum())
            count2 = int((norm.min(axis=1) <= self.distance_thresh).sum())
        if n1 + n2 > 0:
            out[self.metric_name] = (count1 + count2) / (n1 + n2)
        return out

    def update_batch(self, points1, points2, img1_shape, img2_shape,
                     homography) -> Dict[str, float]:
        vals = []
        for i in range(len(points1)):
            one = self.update_one(points1[i], points2[i], img1_shape,
                                  img2_shape, homography[i])
            if self.metric_name in one:
                vals.append(one[self.metric_name])
        return {self.metric_name: float(np.mean(vals)) if vals else 0.0}


class ValidDescriptorsDistance:
    """Descriptor L2 distance + angle at geometrically-valid correspondences
    (reference ValidDescriptorsDistance:160)."""

    def __init__(self, name: str, distance_thresh_list: Sequence[float],
                 ordering: str = "xy") -> None:
        assert ordering in ("xy", "yx")
        self.metric_name = name
        self.distance_thresh_list = list(distance_thresh_list)
        self.ordering = ordering

    def update_one(self, points1, points2, desc1, desc2, img1_shape,
                   img2_shape, homography) -> Dict[str, float]:
        # NOTE the reference flips points when ordering == *xy* here (the
        # inverse of Repeatability) — a quirk we do NOT reproduce: points in
        # `ordering` are converted to xy consistently.
        p1 = _to_xy(np.asarray(points1), self.ordering)
        p2 = _to_xy(np.asarray(points2), self.ordering)
        d1 = np.asarray(desc1, np.float64)
        d2 = np.asarray(desc2, np.float64)
        H = np.asarray(homography, np.float64)

        p2, m2 = _keep_in_frame(p2, np.linalg.inv(H), img1_shape)
        d2 = d2[m2] if len(m2) else d2[:0]
        p1, m1 = _keep_in_frame(p1, H, img2_shape)
        d1 = d1[m1] if len(m1) else d1[:0]
        warped1 = _warp_xy(p1, H)

        n1, n2 = len(warped1), len(p2)
        out: Dict[str, float] = {}
        for thr in self.distance_thresh_list:
            rep = vd = ang = 0.0
            if n1 and n2:
                norm = np.linalg.norm(warped1[:, None] - p2[None], axis=2)

                def side(norm_ax, da, db, axis):
                    mins = norm_ax.min(axis=axis)
                    idx = norm_ax.argmin(axis=axis)
                    sel = mins <= thr
                    va = da[sel]
                    vb = db[idx[sel]]
                    dist = np.linalg.norm(va - vb, axis=1)
                    denom = (np.linalg.norm(va, axis=1)
                             * np.linalg.norm(vb, axis=1))
                    cos = np.clip((va * vb).sum(1) / np.maximum(denom, 1e-12),
                                  -1, 1)
                    return sel.sum(), dist.sum(), np.degrees(
                        np.arccos(cos)).sum()

                c1, s1, a1 = side(norm, d1, d2, 1)
                c2, s2, a2 = side(norm.T, d2, d1, 1)
                rep = (c1 + c2) / (n1 + n2)
                if c1 + c2 > 0:
                    vd = (s1 + s2) / (c1 + c2)
                    ang = (a1 + a2) / (c1 + c2)
                else:
                    # reference semantics: 0/0 -> NaN when no pair falls
                    # within the threshold (keypoints_metrics.py:276-279);
                    # aggregation filters non-finite values, so a 0.0 here
                    # would wrongly drag the mean down
                    vd = ang = float("nan")
            out[f"{self.metric_name}_Repeatability@{thr}"] = float(rep)
            out[f"{self.metric_name}_ValidDistance@{thr}"] = float(vd)
            out[f"{self.metric_name}_Angle@{thr}"] = float(ang)
        return out

    def update_batch(self, points1, points2, desc1, desc2, img1_shape,
                     img2_shape, homography) -> Dict[str, float]:
        acc: Dict[str, List[float]] = {}
        for i in range(len(points1)):
            one = self.update_one(points1[i], points2[i], desc1[i], desc2[i],
                                  img1_shape, img2_shape, homography[i])
            for k, v in one.items():
                acc.setdefault(k, []).append(v)
        return {k: float(np.mean(v)) for k, v in acc.items()}
