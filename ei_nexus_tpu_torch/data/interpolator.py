"""6-DoF pose interpolation: linear translation and slerp rotation.

A copy of `ei_nexus_tpu/data/interpolator.py` (numpy and scipy, on the
host, used when a dataset is built), with scipy imported where it is used.
`interpolate(t)` returns the inverse of the interpolated world pose, that
is T_cam_from_world.
"""

from __future__ import annotations

from typing import Union

import numpy as np


def T_to_Rt(T: np.ndarray, batch: bool = False):
    if batch:
        return T[:, :3, :3], T[:, :3, 3]
    return T[:3, :3], T[:3, 3]


def Rt_to_T(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


class PoseInterpolator:
    def __init__(self, timestamp: np.ndarray, t: np.ndarray, R: np.ndarray,
                 quat_R: bool = True, mode: str = "linear"):
        """timestamp: (N,); t: (N, 3); R: (N, 3, 3) matrices or (N, 4)
        quaternions (xyzw) when quat_R."""
        from scipy.interpolate import interp1d
        from scipy.spatial.transform import Rotation, Slerp
        self.timestamp = np.asarray(timestamp)
        self._t_interp = interp1d(timestamp, np.asarray(t), axis=0, kind=mode,
                                  bounds_error=True)
        rot = (Rotation.from_quat(R) if quat_R
               else Rotation.from_matrix(R))
        self._rot_interp = Slerp(timestamp, rot)

    def interpolate(self, t: Union[float, np.ndarray]) -> np.ndarray:
        """Query time -> 4x4 T_cam_from_world (inverse of the world pose)."""
        T_W_j = np.eye(4)
        T_W_j[:3, 3] = self._t_interp(t)
        T_W_j[:3, :3] = self._rot_interp(t).as_matrix()
        return np.linalg.inv(T_W_j)

    def interpolate_batch(self, ts: np.ndarray) -> np.ndarray:
        """(M,) query times -> (M, 4, 4) camera-from-world transforms."""
        ts = np.asarray(ts)
        T = np.tile(np.eye(4), (len(ts), 1, 1))
        T[:, :3, 3] = self._t_interp(ts)
        T[:, :3, :3] = self._rot_interp(ts).as_matrix()
        return np.linalg.inv(T)
