"""Visualisation on the host: keypoints, matches, depth colour maps and
event accumulation images as uint8 numpy images (cv2 inside the
functions).

Counterpart of `ei_nexus_tpu/utils/visualize.py` (the reference's
`utils/visualize.py:6-48` and the draw helpers of its test scripts).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def accumulation_to_u8(acc: np.ndarray) -> np.ndarray:
    """Min-max normalize an event count/polarity image to uint8 (reference
    draw_events_accumulation_image normalization)."""
    acc = np.asarray(acc, np.float64)
    lo, hi = acc.min(), acc.max()
    if hi - lo < 1e-12:
        return np.zeros(acc.shape, np.uint8)
    img = (acc - lo) / (hi - lo) * 255.0
    return np.clip(img, 0, 255).astype(np.uint8)


def depth_to_color(depth: np.ndarray,
                   valid: Optional[np.ndarray] = None) -> np.ndarray:
    """Depth map -> BGR colormap image (invalid pixels black)."""
    import cv2
    d = np.asarray(depth, np.float64)
    if valid is None:
        valid = np.isfinite(d) & (d > 0)
    vals = d[valid]
    if vals.size == 0:
        return np.zeros(d.shape + (3,), np.uint8)
    lo, hi = np.percentile(vals, 2), np.percentile(vals, 98)
    norm = np.clip((d - lo) / max(hi - lo, 1e-9), 0, 1)
    norm = np.nan_to_num(norm)  # NaN depths (invalid) -> 0 before the cast
    u8 = (norm * 255).astype(np.uint8)
    color = cv2.applyColorMap(u8, cv2.COLORMAP_JET)
    color[~valid] = 0
    return color


def _to_bgr(image: np.ndarray) -> np.ndarray:
    img = np.asarray(image)
    if img.ndim == 3 and img.shape[-1] == 1:
        img = img[..., 0]
    if img.dtype != np.uint8:
        img = np.clip(img, 0, 255).astype(np.uint8)
    if img.ndim == 2:
        img = np.stack([img] * 3, -1)
    return np.ascontiguousarray(img)


def draw_keypoints(image: np.ndarray, keypoints: np.ndarray,
                   ordering: str = "yx",
                   color: Tuple[int, int, int] = (0, 255, 0),
                   radius: int = 2) -> np.ndarray:
    """Draw keypoints ((N, >=2), `ordering`) on a gray/BGR image."""
    import cv2
    img = _to_bgr(image)
    kp = np.asarray(keypoints)[:, :2]
    if ordering == "yx":
        kp = kp[:, ::-1]
    for x, y in kp:
        cv2.circle(img, (int(round(x)), int(round(y))), radius, color, -1)
    return img


def draw_matches(image0: np.ndarray, image1: np.ndarray,
                 mkpts0: np.ndarray, mkpts1: np.ndarray,
                 ordering: str = "yx",
                 inliers: Optional[np.ndarray] = None,
                 max_draw: int = 200) -> np.ndarray:
    """Side-by-side match visualization (green inliers / red outliers)."""
    import cv2
    im0 = _to_bgr(image0)
    im1 = _to_bgr(image1)
    H = max(im0.shape[0], im1.shape[0])
    canvas = np.zeros((H, im0.shape[1] + im1.shape[1], 3), np.uint8)
    canvas[:im0.shape[0], :im0.shape[1]] = im0
    canvas[:im1.shape[0], im0.shape[1]:] = im1
    k0 = np.asarray(mkpts0)[:, :2]
    k1 = np.asarray(mkpts1)[:, :2]
    if ordering == "yx":
        k0, k1 = k0[:, ::-1], k1[:, ::-1]
    n = min(len(k0), max_draw)
    off = im0.shape[1]
    for i in range(n):
        good = True if inliers is None else bool(inliers[i])
        color = (0, 255, 0) if good else (0, 0, 255)
        p0 = (int(round(k0[i, 0])), int(round(k0[i, 1])))
        p1 = (int(round(k1[i, 0])) + off, int(round(k1[i, 1])))
        cv2.line(canvas, p0, p1, color, 1, cv2.LINE_AA)
        cv2.circle(canvas, p0, 2, color, -1)
        cv2.circle(canvas, p1, 2, color, -1)
    return canvas


def overlay_events_on_image(image: np.ndarray, acc: np.ndarray,
                            alpha: float = 0.6) -> np.ndarray:
    """Blend an event accumulation map (red) over a grayscale frame."""
    img = _to_bgr(image).astype(np.float64)
    a = accumulation_to_u8(acc).astype(np.float64)
    img[..., 2] = np.clip(img[..., 2] * (1 - alpha) + a * alpha, 0, 255)
    return img.astype(np.uint8)
