"""Matching metrics: matching ratio, mean matching accuracy, homography
estimation, relative pose estimation, and the assignment-level matcher
metrics.

A copy of `ei_nexus_tpu/metrics/matching.py` (host-side numpy, cv2
imported where it is used), with the reference's RANSAC protocol
(K-normalised keypoints, the threshold over the mean focal length,
recoverPose over the E candidates). `RelativePoseEstimation(backend=
"torch")` is the JAX package's backend "jax": OpenCV's per-pair RANSAC
swapped for the batched RANSAC of `ransac.py` on `device` (the card
unless the caller names another).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from .auc import compute_auc
from .keypoints import _to_xy, _warp_xy


class MatchingRatio:
    """matched / min(detected) (reference MatchingRatio:30)."""

    def __init__(self, name: str) -> None:
        self.metric_name = name

    def update_one(self, matched_keypoints1, matched_keypoints2, keypoints1,
                   keypoints2) -> Dict[str, float]:
        n_kp = min(len(keypoints1), len(keypoints2))
        assert len(matched_keypoints1) == len(matched_keypoints2)
        return {self.metric_name:
                len(matched_keypoints1) / (n_kp + 1e-8)}

    def update_batch(self, matched_keypoints1, matched_keypoints2, keypoints1,
                     keypoints2) -> Dict[str, float]:
        vals = [self.update_one(matched_keypoints1[i], matched_keypoints2[i],
                                keypoints1[i], keypoints2[i])[self.metric_name]
                for i in range(len(matched_keypoints1))]
        return {self.metric_name: float(np.mean(vals)) if vals else 0.0}


class MeanMatchingAccuracy:
    """Fraction of matches whose homography reprojection error <= threshold
    (reference MeanMatchingAccuracy:84)."""

    def __init__(self, name: str, threshold: float = 3,
                 ordering: str = "yx") -> None:
        assert ordering in ("xy", "yx")
        self.metric_name = name
        self._threshold = threshold
        self._ordering = ordering

    def update_one(self, matched_keypoints, warped_matched_keypoints,
                   true_homography) -> Dict[str, float]:
        mk = np.asarray(matched_keypoints, np.float64)
        wk = np.asarray(warped_matched_keypoints, np.float64)
        if mk.size == 0 or wk.size == 0:
            return {self.metric_name: 0.0}
        p1 = _to_xy(mk, self._ordering)
        p2 = _to_xy(wk, self._ordering)
        H = np.asarray(true_homography, np.float64)
        true_warped = _warp_xy(p1, H)
        good = np.linalg.norm(true_warped - p2, axis=1) <= self._threshold
        return {self.metric_name: float(good.mean()) if good.size else 0.0}

    def update_batch(self, matched_keypoints, warped_matched_keypoints,
                     true_homographies) -> Dict[str, float]:
        vals = []
        for i in range(len(matched_keypoints)):
            if np.asarray(matched_keypoints[i]).size == 0:
                continue
            vals.append(self.update_one(
                matched_keypoints[i], warped_matched_keypoints[i],
                true_homographies[i])[self.metric_name])
        return {self.metric_name: float(np.mean(vals)) if vals else 0.0}


class HomographyEstimation:
    """cv2 RANSAC homography + corner error + AUC
    (reference HomographyEstimation:188)."""

    def __init__(self, name: str, correctness_thresh: Sequence[float],
                 ordering: str = "yx") -> None:
        assert ordering in ("xy", "yx")
        self.metric_name = name
        self.correctness_thresh = list(correctness_thresh)
        self.ordering = ordering
        self.error_list: List[float] = []

    def estimate_homography(self, mk1, mk2):
        import cv2
        mk1 = np.asarray(mk1, np.float64)
        mk2 = np.asarray(mk2, np.float64)
        if mk1.shape[0] < 4:
            return None, None
        p1 = _to_xy(mk1, self.ordering).astype(np.float64)
        p2 = _to_xy(mk2, self.ordering).astype(np.float64)
        H, mask = cv2.findHomography(p1, p2, method=cv2.RANSAC)
        if H is None:
            return None, None
        return H, mask

    def compute_all_auc(self) -> Dict[str, float]:
        return compute_auc(self.error_list, self.correctness_thresh)

    def update_one(self, img_shape, matched_keypoints1, matched_keypoints2,
                   true_homography) -> Dict[str, float]:
        out: Dict[str, float] = {}
        H_pred, inliers = self.estimate_homography(matched_keypoints1,
                                                   matched_keypoints2)
        if H_pred is None:
            for t in self.correctness_thresh:
                out[f"{self.metric_name}@{t}_ratio"] = 0.0
            out[self.metric_name + "_errors"] = np.inf
            out[self.metric_name + "_inliers"] = 0.0
            self.error_list.append(np.inf)
            return out

        H_true = np.asarray(true_homography, np.float64)
        corners = np.array([
            [0, 0], [img_shape[1] - 1, 0], [0, img_shape[0] - 1],
            [img_shape[1] - 1, img_shape[0] - 1]], np.float64)
        real = _warp_xy(corners, H_true)
        pred = _warp_xy(corners, H_pred)
        mean_dist = float(np.linalg.norm(real - pred, axis=1).mean())
        for t in self.correctness_thresh:
            out[f"{self.metric_name}@{t}_ratio"] = float(mean_dist <= t)
        out[self.metric_name + "_errors"] = mean_dist
        out[self.metric_name + "_inliers"] = float(np.asarray(inliers).mean())
        self.error_list.append(mean_dist)
        return out

    def update_batch(self, img_shapes, matched_keypoints1, matched_keypoints2,
                     true_homographies) -> Dict[str, float]:
        self.error_list = []
        acc: Dict[str, List[float]] = {}
        for i in range(len(matched_keypoints1)):
            one = self.update_one(img_shapes[i], matched_keypoints1[i],
                                  matched_keypoints2[i], true_homographies[i])
            for k, v in one.items():
                acc.setdefault(k, []).append(v)
        out = {k: float(np.mean(v)) for k, v in acc.items()}
        auc = self.compute_all_auc()
        for t in self.correctness_thresh:
            out[f"{self.metric_name}@{t}_auc"] = auc[f"{t}"]
        return out


class RelativePoseEstimation:
    """Essential-matrix RANSAC + pose recovery + angular errors + pose AUC
    (reference RelativePoseEstimation:347). The headline RPE metric.

    backend="opencv": the reference's exact protocol (host, per pair).
    backend="torch" (the JAX package's "jax"): the batched RANSAC of
    metrics/ransac.py on `device`; `solver` picks "8pt" or "5pt" (Nistér's
    minimal solver, the hypothesis family of cv2.findEssentialMat,
    metrics/fivepoint.py).
    """

    def __init__(self, name: str, pose_thresh: Sequence[float],
                 ransac_thresh: float = 1.0, ransac_conf: float = 0.999,
                 ordering: str = "yx", backend: str = "opencv",
                 solver: str = "5pt", device=None) -> None:
        assert ordering in ("xy", "yx")
        if backend not in ("opencv", "torch"):
            raise ValueError(f"unknown RANSAC backend {backend!r}")
        self.metric_name = name
        self.pose_thresh = list(pose_thresh)
        self.ransac_thresh = ransac_thresh
        self.ransac_conf = ransac_conf
        self.ordering = ordering
        self.backend = backend
        self.solver = solver
        self.device = device
        self.error_list: List[float] = []

    # -- pose estimation ---------------------------------------------------
    def estimate_pose(self, mk1, mk2, K0, K1, thresh, conf):
        mk1 = np.asarray(mk1, np.float64)
        mk2 = np.asarray(mk2, np.float64)
        if mk1.shape[0] < 5:
            return None
        p1 = _to_xy(mk1, self.ordering)
        p2 = _to_xy(mk2, self.ordering)
        K0 = np.asarray(K0, np.float64)
        K1 = np.asarray(K1, np.float64)
        # normalize pixel coords by intrinsics
        p1n = (p1 - K0[[0, 1], [2, 2]][None]) / K0[[0, 1], [0, 1]][None]
        p2n = (p2 - K1[[0, 1], [2, 2]][None]) / K1[[0, 1], [0, 1]][None]
        ransac_thr = thresh / np.mean([K0[0, 0], K1[1, 1], K0[0, 0],
                                       K1[1, 1]])
        if self.backend == "torch":
            from .ransac import estimate_pose_torch
            return estimate_pose_torch(p1n, p2n, ransac_thr,
                                       solver=self.solver,
                                       device=self.device)
        import cv2
        E, mask = cv2.findEssentialMat(p1n, p2n, np.eye(3),
                                       threshold=ransac_thr, prob=conf,
                                       method=cv2.RANSAC)
        if E is None:
            return None
        best_num_inliers = 0
        ret = None
        for _E in np.split(E, len(E) / 3):
            n, R, t, _ = cv2.recoverPose(_E, p1n, p2n, np.eye(3), 1e9,
                                         mask=mask)
            if n > best_num_inliers:
                ret = (R, t[:, 0], mask.ravel() > 0)
                best_num_inliers = n
        return ret

    @staticmethod
    def relative_pose_error(T_0to1, R, t):
        T = np.asarray(T_0to1, np.float64)
        t_gt = T[:3, 3]
        n = np.linalg.norm(t) * np.linalg.norm(t_gt)
        t_err = np.degrees(np.arccos(np.clip(np.dot(t, t_gt) / max(n, 1e-12),
                                             -1.0, 1.0)))
        t_err = min(t_err, 180 - t_err)
        if not np.isfinite(np.linalg.norm(t_gt)):
            t_err = 0.0
        R_gt = T[:3, :3]
        cos = np.clip((np.trace(R.T @ R_gt) - 1) / 2, -1.0, 1.0)
        R_err = np.degrees(np.abs(np.arccos(cos)))
        return float(t_err), float(R_err)

    def compute_all_auc(self) -> Dict[str, float]:
        return compute_auc(self.error_list, self.pose_thresh)

    def update_one(self, mk1, mk2, K0, K1, T_0to1) -> Dict[str, float]:
        ret = self.estimate_pose(mk1, mk2, K0, K1, self.ransac_thresh,
                                 self.ransac_conf)
        return self._score_pose(ret, T_0to1)

    def _score_pose(self, ret, T_0to1) -> Dict[str, float]:
        """Shared scoring for one pair given (R, t, inliers) or None."""
        out: Dict[str, float] = {}
        if ret is None:
            out[self.metric_name + "_R_errs"] = np.inf
            out[self.metric_name + "_t_errs"] = np.inf
            out[self.metric_name + "_pose_errs"] = np.inf
            out[self.metric_name + "_inliers"] = 0.0
            for t in self.pose_thresh:
                out[f"{self.metric_name}@{t}_ratio"] = 0.0
            self.error_list.append(np.inf)
            return out
        R, t, inliers = ret
        t_err, R_err = self.relative_pose_error(np.asarray(T_0to1), R, t)
        pose_err = max(R_err, t_err) if np.isfinite(t_err) else R_err
        out[self.metric_name + "_R_errs"] = R_err
        out[self.metric_name + "_t_errs"] = t_err
        out[self.metric_name + "_pose_errs"] = pose_err
        out[self.metric_name + "_inliers"] = float(np.mean(inliers))
        for th in self.pose_thresh:
            out[f"{self.metric_name}@{th}_ratio"] = float(pose_err <= th)
        self.error_list.append(pose_err)
        return out

    def update_batch_device(self, positions0, positions1, matches0, K0, K1,
                            T_0to1) -> List[Dict[str, float]]:
        """Batched path: ONE device RANSAC call for the whole batch.

        Takes the matcher's fixed-K outputs directly (positions (B, K, >=2)
        in `self.ordering`, matches0 (B, K) with <0 = unmatched) instead of
        ragged per-pair matched lists. Only for backend="torch".
        """
        from .ransac import estimate_pose_batch_from_matches
        rets = estimate_pose_batch_from_matches(
            np.asarray(positions0), np.asarray(positions1),
            np.asarray(matches0), np.asarray(K0), np.asarray(K1),
            self.ransac_thresh, ordering=self.ordering,
            solver=self.solver, device=self.device)
        return [self._score_pose(ret, np.asarray(T_0to1)[b])
                for b, ret in enumerate(rets)]

    def update_batch(self, mk1, mk2, K0, K1, T_0to1) -> Dict[str, float]:
        self.error_list = []
        acc: Dict[str, List[float]] = {}
        for i in range(len(mk1)):
            one = self.update_one(mk1[i], mk2[i], K0[i], K1[i], T_0to1[i])
            for k, v in one.items():
                acc.setdefault(k, []).append(v)
        out = {}
        for k, v in acc.items():
            arr = np.asarray(v, np.float64)
            arr = arr[np.isfinite(arr)]
            out[k] = float(arr.mean()) if arr.size else float("nan")
        auc = self.compute_all_auc()
        for t in self.pose_thresh:
            out[f"{self.metric_name}@{t}_auc"] = auc[f"{t}"]
        return out


# ---------------------------------------------------------------------------
# Assignment-level matcher metrics (reference lightglue.py:17 matcher_metrics)
# ---------------------------------------------------------------------------


def matcher_metrics(pred_matches0, gt_matches0, matching_scores0,
                    prefix: str = "") -> Dict[str, np.ndarray]:
    """Per-sample recall / precision / accuracy / ranking-AP of predicted
    assignments vs GT labels ({idx, -1 unmatched, -2 ignore}).

    pred_matches0: (B, N) predicted indices; gt_matches0: (B, N) labels;
    matching_scores0: (B, N). Vectorized numpy (the reference computes the
    same quantities in torch, lightglue.py:19-45).
    """
    m = np.asarray(pred_matches0)
    gt = np.asarray(gt_matches0)
    sc = np.asarray(matching_scores0)

    def _div(a, b):
        return a / (1e-8 + b)

    rec_mask = (gt > -1)
    acc_mask = (gt >= -1)
    prec_mask = (m > -1) & (gt >= -1)
    correct = (m == gt)

    recall = _div((correct & rec_mask).sum(1), rec_mask.sum(1))
    accuracy = _div((correct & acc_mask).sum(1), acc_mask.sum(1))
    precision = _div((correct & prec_mask).sum(1), prec_mask.sum(1))

    # ranking AP: precision-weighted recall increments in score order
    order = np.argsort(-sc, axis=1)
    s_tp = np.take_along_axis(correct, order, 1)
    s_p = np.take_along_axis(prec_mask, order, 1).astype(np.float64)
    s_r = np.take_along_axis(rec_mask, order, 1).astype(np.float64)
    p_pts = _div(np.cumsum(s_tp * s_p, 1), np.cumsum(s_p, 1))
    r_pts = _div(np.cumsum(s_tp * s_r, 1), s_r.sum(1, keepdims=True))
    r_diff = np.diff(r_pts, axis=1)
    ap = (r_diff * p_pts[:, 1:]).sum(1)

    return {
        f"{prefix}match_recall": recall,
        f"{prefix}match_precision": precision,
        f"{prefix}accuracy": accuracy,
        f"{prefix}average_precision": ap,
    }
