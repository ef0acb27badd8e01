"""Host-side augmentations: event-point, image and pair transforms.

A copy of `ei_nexus_tpu/data/augment.py` (numpy, with cv2 imported where it
is used for rotation), applied per sample on the host before the transfer
to the device. `EventPointsAugmentation` and `ImageArrayAugmentation` pass
their input through unless `enabled`, as in the JAX package;
`PairAugmentation` (flip, rotate and random crop of maps) and
`PairAugmentationEvents` (the same transform on raw event coordinates and
the frame) are active.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


class EventPointsAugmentation:
    """Event-stream point augmentation (disabled by default, as in the
    reference: augment.py:213-219 are commented out)."""

    def __init__(self, time_scale=(0.8, 1.2), slice_dt=(35, 40),
                 slice_mode="random", flip_p=0.5, xy_std=1.5, ts_std=0.5,
                 add_percent=(0.001, 0.01), del_percent=(0.001, 0.01),
                 enabled: bool = False,
                 rng: Optional[np.random.Generator] = None):
        self.time_scale = time_scale
        self.flip_p = flip_p
        self.del_percent = del_percent
        self.enabled = enabled
        self.rng = rng or np.random.default_rng()

    def __call__(self, events: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        if not self.enabled:
            return events
        rng = self.rng
        t = events["t"].astype(np.float64)
        # random time scaling around the window start
        scale = rng.uniform(*self.time_scale)
        t = t[0] + (t - t[0]) * scale if len(t) else t
        x, y, p = events["x"], events["y"], events["p"]
        # random temporal flip
        if rng.uniform() < self.flip_p and len(t):
            t = t[0] + (t[-1] - t)[::-1]
            x, y, p = x[::-1], y[::-1], 1 - p
        # random deletion
        frac = rng.uniform(*self.del_percent)
        keep = rng.uniform(size=len(t)) >= frac
        return {"x": x[keep], "y": y[keep], "t": t[keep], "p": p[keep]}


class ImageArrayAugmentation:
    """Image photometric augmentation (disabled in the reference:
    augment.py:282-284 return the input unchanged)."""

    def __init__(self, enabled: bool = False,
                 brightness_limit=(-0.3, 0.0), contrast_limit=(-0.5, 0.3),
                 noise_p=0.5, noise_std=5.0,
                 rng: Optional[np.random.Generator] = None, **_unused):
        self.enabled = enabled
        self.brightness_limit = brightness_limit
        self.contrast_limit = contrast_limit
        self.noise_p = noise_p
        self.noise_std = noise_std
        self.rng = rng or np.random.default_rng()

    def __call__(self, img: np.ndarray) -> np.ndarray:
        if not self.enabled:
            return img
        rng = self.rng
        out = img.astype(np.float32)
        b = rng.uniform(*self.brightness_limit)
        c = 1.0 + rng.uniform(*self.contrast_limit)
        out = (out - 127.5) * c + 127.5 + b * 255.0
        if rng.uniform() < self.noise_p:
            out = out + rng.normal(0, self.noise_std, out.shape)
        return np.clip(out, 0, 255).astype(img.dtype)


def _rotate_maps(arrs, angle_deg: float):
    """Rotate (C, H, W) arrays about the image center (bilinear, zero fill)
    — torchvision TF.rotate semantics."""
    import cv2
    out = []
    for a in arrs:
        C, H, W = a.shape
        M = cv2.getRotationMatrix2D(((W - 1) / 2.0, (H - 1) / 2.0),
                                    angle_deg, 1.0)
        rot = np.stack([
            cv2.warpAffine(a[c], M, (W, H), flags=cv2.INTER_LINEAR,
                           borderValue=0.0) for c in range(C)])
        out.append(rot)
    return out


class PairAugmentation:
    """Joint flip + rotate + random crop of the (events_rep, image,
    events_image) triple (reference PairAugmentation:222, active)."""

    def __init__(self, crop_size: Tuple[int, int], flip_p_h: float = 0.5,
                 flip_p_w: float = 0.5, rotate_angle: float = 10.0,
                 rng: Optional[np.random.Generator] = None):
        self.crop_size = tuple(crop_size)
        self.flip_p_h = flip_p_h
        self.flip_p_w = flip_p_w
        self.rotate_angle = rotate_angle
        self.rng = rng or np.random.default_rng()

    def __call__(self, x: np.ndarray, y: np.ndarray,
                 mask: Optional[np.ndarray] = None):
        """x, y, mask: (C, H, W) arrays augmented with the SAME transform."""
        rng = self.rng
        arrs = [x, y] + ([mask] if mask is not None else [])
        if rng.uniform() < self.flip_p_h:
            arrs = [a[:, ::-1, :].copy() for a in arrs]
        if rng.uniform() < self.flip_p_w:
            arrs = [a[:, :, ::-1].copy() for a in arrs]
        angle = rng.uniform(-self.rotate_angle, self.rotate_angle)
        arrs = _rotate_maps([a.astype(np.float32) for a in arrs], angle)
        ch, cw = self.crop_size
        H, W = arrs[0].shape[-2:]
        top = rng.integers(0, max(H - ch, 0) + 1)
        left = rng.integers(0, max(W - cw, 0) + 1)
        arrs = [a[:, top:top + ch, left:left + cw] for a in arrs]
        if mask is not None:
            return arrs[0], arrs[1], arrs[2]
        return arrs[0], arrs[1], None


class PairAugmentationEvents:
    """Pair augmentation applied to RAW events + image (flip / rotate /
    crop with one shared transform).

    The reference's PairAugmentation acts on the rasterized maps
    (events_rep, image, events_image); this framework rasterizes on device,
    so the same geometric transform is applied to the event COORDINATES and
    the image instead — equivalent output voxel grids (up to rasterization
    of rotated bilinear footprints) without materializing maps on the host.
    Single-view (same-time) training only, like the reference
    (augment_pair=True path). K / pose are intentionally left untouched:
    same-time pairs have identity relative pose, so the GT correspondence
    is the identity map regardless of intrinsics (the reference likewise
    augments only the rasterized maps).
    """

    def __init__(self, crop_size: Tuple[int, int], flip_p_h: float = 0.5,
                 flip_p_w: float = 0.5, rotate_angle: float = 10.0,
                 rng: Optional[np.random.Generator] = None):
        self.crop_size = tuple(crop_size)
        self.flip_p_h = flip_p_h
        self.flip_p_w = flip_p_w
        self.rotate_angle = rotate_angle
        self.rng = rng or np.random.default_rng()

    def __call__(self, sample: Dict[str, np.ndarray],
                 rng: Optional[np.random.Generator] = None
                 ) -> Dict[str, np.ndarray]:
        """sample: view dict with events_x/y (padded), events_valid, image
        (H, W, 1) [+ depth/depth_mask]. Returns a new dict with the crop's
        resolution.

        rng: per-sample generator (pass one derived from (seed, epoch,
        index) for thread-safe, preemption-reproducible augmentation —
        the shared self.rng fallback is NOT deterministic under
        multi-threaded loading).
        """
        import cv2
        rng = rng if rng is not None else self.rng
        out = dict(sample)
        H, W = sample["image"].shape[:2]
        x = sample["events_x"].copy()
        y = sample["events_y"].copy()
        image = sample["image"][..., 0].astype(np.float32)
        depth = out.get("depth")
        dmask = out.get("depth_mask")

        flip_h = rng.uniform() < self.flip_p_h
        flip_w = rng.uniform() < self.flip_p_w
        if flip_h:
            y = (H - 1) - y
            image = image[::-1]
            if depth is not None:
                depth = depth[::-1]
                dmask = dmask[::-1]
        if flip_w:
            x = (W - 1) - x
            image = image[:, ::-1]
            if depth is not None:
                depth = depth[:, ::-1]
                dmask = dmask[:, ::-1]

        angle = rng.uniform(-self.rotate_angle, self.rotate_angle)
        cx, cy = (W - 1) / 2.0, (H - 1) / 2.0
        ca, sa = np.cos(np.radians(angle)), np.sin(np.radians(angle))
        # rotate event coords by +angle about the center (image rotated with
        # the same convention via cv2.getRotationMatrix2D)
        xr = ca * (x - cx) + sa * (y - cy) + cx
        yr = -sa * (x - cx) + ca * (y - cy) + cy
        M = cv2.getRotationMatrix2D((cx, cy), angle, 1.0)
        image = cv2.warpAffine(np.ascontiguousarray(image), M, (W, H),
                               flags=cv2.INTER_LINEAR, borderValue=0.0)
        if depth is not None:
            depth = cv2.warpAffine(np.ascontiguousarray(depth), M, (W, H),
                                   flags=cv2.INTER_NEAREST, borderValue=0.0)
            dmask = cv2.warpAffine(
                np.ascontiguousarray(dmask.astype(np.uint8)), M, (W, H),
                flags=cv2.INTER_NEAREST, borderValue=0) > 0

        ch, cw = self.crop_size
        ch, cw = min(ch, H), min(cw, W)
        top = int(rng.integers(0, H - ch + 1))
        left = int(rng.integers(0, W - cw + 1))
        xr = xr - left
        yr = yr - top
        inb = (xr >= 0) & (xr < cw) & (yr >= 0) & (yr < ch)
        out["events_x"] = np.where(inb, xr, -1.0).astype(np.float32)
        out["events_y"] = np.where(inb, yr, -1.0).astype(np.float32)
        out["events_valid"] = sample["events_valid"] & inb
        out["image"] = image[top:top + ch, left:left + cw, None]
        if depth is not None:
            out["depth"] = depth[top:top + ch, left:left + cw]
            out["depth_mask"] = dmask[top:top + ch, left:left + cw]
        return out
