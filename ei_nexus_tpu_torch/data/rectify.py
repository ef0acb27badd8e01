"""Offline data preparation on the host: MVSEC rectification and EC
undistortion (numpy, cv2 inside the functions).

Counterpart of `ei_nexus_tpu/data/rectify.py` (the reference's
`datasets/MVSEC_rectify.py:11` and `datasets/rectify_ec.py:19`): images
remapped through the calibration maps, events re-mapped through the same
maps and filtered to the frame; EC's undistortion through the pinhole
radial-tangential model. The outputs are the `*_rectified.h5` /
`events_corrected.npy` layouts the readers take.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np


def rectify_images(images: np.ndarray, x_map: np.ndarray,
                   y_map: np.ndarray) -> np.ndarray:
    """Remap (N, H, W) images with calibration maps (cv2.INTER_LINEAR)."""
    import cv2
    out = np.zeros_like(images)
    for i in range(images.shape[0]):
        out[i] = cv2.remap(images[i], x_map, y_map, cv2.INTER_LINEAR)
    return out


def rectify_events(events: np.ndarray, x_map: np.ndarray, y_map: np.ndarray,
                   resolution: Tuple[int, int]) -> np.ndarray:
    """Map (N, 4) xytp events through inverse rectification maps.

    The maps give, for each RECTIFIED pixel, the source coordinate — the
    reference indexes them at the (rounded) raw event position and takes the
    stored coordinates as the rectified position (MVSEC convention), then
    drops events outside [0, W-1) x [0, H-1).
    """
    W, H = resolution
    out = events.copy()
    ox = np.round(events[:, 0]).astype(np.int32)
    oy = np.round(events[:, 1]).astype(np.int32)
    ox = np.clip(ox, 0, x_map.shape[1] - 1)
    oy = np.clip(oy, 0, x_map.shape[0] - 1)
    out[:, 0] = x_map[oy, ox]
    out[:, 1] = y_map[oy, ox]
    keep = ((out[:, 0] >= 0) & (out[:, 0] < W - 1)
            & (out[:, 1] >= 0) & (out[:, 1] < H - 1))
    return out[keep]


def rectify_mvsec_sequence(archive, sequence: str,
                           resolution: Tuple[int, int] = (346, 260)):
    """Rectify one MVSEC sequence's raw images + events using the scene's
    calibration maps (<root>/<scene>_calib/<scene>_left_{x,y}_map.txt).

    archive: the port's data.mvsec.MVSECArchive (with raw files present).
    Returns (rect_images, rect_events).
    """
    from .mvsec import SCENE_OF
    scene = SCENE_OF[sequence]
    calib_dir = os.path.join(archive.data_path, f"{scene}_calib")
    x_map = np.loadtxt(os.path.join(calib_dir, f"{scene}_left_x_map.txt"),
                       dtype=np.float32)
    y_map = np.loadtxt(os.path.join(calib_dir, f"{scene}_left_y_map.txt"),
                       dtype=np.float32)
    f = archive._seq_file(sequence, "_data.hdf5")
    images = np.asarray(f["davis"]["left"]["image_raw"])
    events = np.asarray(f["davis"]["left"]["events"])
    return (rectify_images(images, x_map, y_map),
            rectify_events(events, x_map, y_map, resolution))


def undistort_events_pinhole(events: np.ndarray, K: np.ndarray,
                             dist: np.ndarray,
                             resolution: Tuple[int, int]) -> np.ndarray:
    """Undistort (N, 4) txyp EC events with cv2.undistortPoints (reference
    rectify_ec.py). Note EC column order is (t, x, y, p)."""
    import cv2
    W, H = resolution
    pts = events[:, 1:3].astype(np.float64).reshape(-1, 1, 2)
    und = cv2.undistortPoints(pts, K, np.asarray(dist, np.float64),
                              P=K).reshape(-1, 2)
    out = events.copy()
    out[:, 1] = und[:, 0]
    out[:, 2] = und[:, 1]
    keep = ((out[:, 1] >= 0) & (out[:, 1] < W - 1)
            & (out[:, 2] >= 0) & (out[:, 2] < H - 1))
    return out[keep]


def undistort_images_pinhole(images: np.ndarray, K: np.ndarray,
                             dist: np.ndarray) -> np.ndarray:
    import cv2
    out = np.zeros_like(images)
    for i in range(images.shape[0]):
        out[i] = cv2.undistort(images[i], K, np.asarray(dist, np.float64))
    return out
