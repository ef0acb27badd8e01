"""Geometry of the stage-2 supervision and the SLAM back end: SE(3)
poses, pinhole cameras, depth reprojection, epipolar distances,
homography warping, ground-truth matches from pose and depth or from a
known homography, and linear triangulation (`triangulation`).
Counterpart of `ei_nexus_tpu/geometry/`."""

from .se3 import Pose
from .camera import Camera
from . import depthproj, epipolar, homography
from .gt_matches import gt_matches_from_homography, gt_matches_from_pose_depth

__all__ = ["Pose", "Camera", "depthproj", "epipolar", "homography",
           "gt_matches_from_pose_depth", "gt_matches_from_homography"]
