"""Geometry of the stage-2 supervision: SE(3) poses, pinhole cameras,
depth reprojection, epipolar distances and ground-truth matches from pose
and depth. Counterpart of `ei_nexus_tpu/geometry/` (the homography path
comes with the homography step)."""

from .se3 import Pose
from .camera import Camera
from . import depthproj, epipolar
from .gt_matches import gt_matches_from_pose_depth

__all__ = ["Pose", "Camera", "depthproj", "epipolar",
           "gt_matches_from_pose_depth"]
