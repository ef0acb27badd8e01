"""Evaluation metrics. Counterpart of `ei_nexus_tpu/metrics/`: the
keypoint and matching metrics and the error-recall AUC (host-side numpy,
`keypoints.py`, `matching.py`, `auc.py`), and the pose tail: the batched
5-point solver (`fivepoint.py`) and the essential-matrix RANSAC with pose
recovery (`ransac.py`), on whatever device their inputs lie."""

from .auc import compute_auc
from .keypoints import (Repeatability, ValidDescriptorsDistance,
                        detection_metric)
from .matching import (HomographyEstimation, MatchingRatio,
                       MeanMatchingAccuracy, RelativePoseEstimation,
                       matcher_metrics)
from .fivepoint import five_point_candidates
from .ransac import (estimate_essential_ransac, estimate_pose_batch,
                     estimate_pose_batch_from_matches, estimate_pose_torch,
                     recover_pose_from_essential, sample_indices)

__all__ = [
    "compute_auc", "detection_metric", "Repeatability",
    "ValidDescriptorsDistance", "MatchingRatio", "MeanMatchingAccuracy",
    "HomographyEstimation", "RelativePoseEstimation", "matcher_metrics",
    "five_point_candidates", "estimate_essential_ransac",
    "estimate_pose_batch", "estimate_pose_batch_from_matches",
    "estimate_pose_torch", "recover_pose_from_essential", "sample_indices",
]
