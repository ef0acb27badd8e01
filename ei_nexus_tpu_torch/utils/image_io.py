"""Image reading and preprocessing on the host (numpy, cv2 inside the
functions).

Counterpart of `ei_nexus_tpu/utils/image_io.py` (the reference's
read_image / resize_image / load_image / ImagePreprocessor): NHWC numpy.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np


def read_image(path: str, grayscale: bool = True) -> np.ndarray:
    import cv2
    import os
    if not os.path.exists(path):
        raise FileNotFoundError(f"No image at path {path}.")
    mode = cv2.IMREAD_GRAYSCALE if grayscale else cv2.IMREAD_COLOR
    image = cv2.imread(str(path), mode)
    if image is None:
        raise IOError(f"Could not read image at {path}.")
    if not grayscale:
        image = image[..., ::-1]
    return image


def image_to_array(image: np.ndarray, scale: bool = True) -> np.ndarray:
    """HxW or HxWxC uint8 -> (H, W, C) float32 (optionally /255)."""
    if image.ndim == 2:
        image = image[..., None]
    out = image.astype(np.float32)
    return out / 255.0 if scale else out


def resize_image(image: np.ndarray, size: Union[int, Tuple[int, int]],
                 fn: str = "max", interp: str = "area"):
    """Resize to a fixed (H, W) or by max/min edge; returns (image,
    (sx, sy)) like the reference."""
    import cv2
    h, w = image.shape[:2]
    chooser = {"max": max, "min": min}[fn]
    if isinstance(size, int):
        scale = size / chooser(h, w)
        h_new, w_new = int(round(h * scale)), int(round(w * scale))
    else:
        h_new, w_new = size
    mode = {"linear": cv2.INTER_LINEAR, "cubic": cv2.INTER_CUBIC,
            "nearest": cv2.INTER_NEAREST, "area": cv2.INTER_AREA}[interp]
    out = cv2.resize(image, (w_new, h_new), interpolation=mode)
    return out, (w_new / w, h_new / h)


def load_image(path: str, resize: Optional[int] = None,
               **kwargs) -> np.ndarray:
    image = read_image(path)
    if resize is not None:
        image, _ = resize_image(image, resize, **kwargs)
    return image_to_array(image)


class ImagePreprocessor:
    """Resize-by-side preprocessor returning (image, scale) (reference
    ImagePreprocessor)."""

    def __init__(self, resize: Optional[Union[int, Tuple[int, int]]] = None,
                 side: str = "long", interpolation: str = "linear"):
        self.resize = resize
        self.side = {"long": "max", "short": "min"}.get(side, side)
        self.interpolation = interpolation

    def __call__(self, img: np.ndarray):
        h, w = img.shape[:2]
        if self.resize is None:
            return img, (1.0, 1.0)
        out, scale = resize_image(img, self.resize, fn=self.side,
                                  interp=self.interpolation)
        return out, scale
