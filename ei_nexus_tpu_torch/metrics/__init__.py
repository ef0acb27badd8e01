"""Evaluation metrics. Counterpart of `ei_nexus_tpu/metrics/`; so far the
pose tail of the serving path: the batched 5-point solver
(`fivepoint.py`) and the essential-matrix RANSAC with pose recovery
(`ransac.py`), on whatever device their inputs lie."""

from .fivepoint import five_point_candidates
from .ransac import (estimate_essential_ransac, estimate_pose_batch,
                     estimate_pose_batch_from_matches,
                     recover_pose_from_essential, sample_indices)

__all__ = [
    "five_point_candidates", "estimate_essential_ransac",
    "estimate_pose_batch", "estimate_pose_batch_from_matches",
    "recover_pose_from_essential", "sample_indices",
]
