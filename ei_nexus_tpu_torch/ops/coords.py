"""Feature-map <-> image coordinate mappings through conv stacks.

A copy of `ei_nexus_tpu/ops/coords.py` (pure Python). Each conv or pool
layer induces an affine map from feature coordinates to input-image
coordinates; composing a stack gives the exact offset and stride of its
output grid. It derives the "+9 px" remap that the VALID-padding
(padding=0) cell-1 extractors apply to keypoint positions, and the cell-8
grid's 3.5 px offset.

Convention: coordinates are pixel-CENTER positions (i + 0.5); a mapping
holds  image_coord = scale * feature_coord + offset  per axis (isotropic:
every layer used is square).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence


@dataclass(frozen=True)
class CoordinateMapping:
    """Affine feature->image coordinate map (center convention)."""

    scale: float = 1.0
    offset: float = 0.0

    def compose(self, inner: "CoordinateMapping") -> "CoordinateMapping":
        """self ∘ inner: apply `inner` (closer to the image) after `self`'s
        feature grid, i.e. map feature coords of the deeper layer through
        the shallower one."""
        return CoordinateMapping(scale=inner.scale * self.scale,
                                 offset=inner.scale * self.offset
                                 + inner.offset)

    def to_image(self, feature_coord):
        return self.scale * feature_coord + self.offset

    def to_feature(self, image_coord):
        return (image_coord - self.offset) / self.scale


def conv2d_mapping(kernel: int, stride: int = 1,
                   padding: int = 0) -> CoordinateMapping:
    """Mapping induced by a conv layer: output center o maps to input
    center  stride*o + (kernel-1)/2 - padding."""
    return CoordinateMapping(scale=float(stride),
                             offset=(kernel - 1) / 2.0 - padding)


def pool2d_mapping(kernel: int, stride: int | None = None
                   ) -> CoordinateMapping:
    s = stride if stride is not None else kernel
    return conv2d_mapping(kernel, s, padding=0)


def stack_mapping(layers: Sequence[CoordinateMapping]) -> CoordinateMapping:
    """Compose layer mappings input-side first: layers[0] touches the
    image."""
    m = CoordinateMapping()
    for layer in layers:
        m = CoordinateMapping(scale=m.scale * layer.scale,
                              offset=m.offset + m.scale * layer.offset)
    return m


def vgg_np_padding0_mapping() -> CoordinateMapping:
    """The cell-1 VGG extractor with padding=0: 8 backbone convs (3x3,
    VALID) + head 3x3 VALID + head 1x1. Yields scale 1, offset +9 — the
    reference's hardcoded remap (EventExtractors.py mapping_positions)."""
    layers = [conv2d_mapping(3) for _ in range(8)]      # backbone
    layers.append(conv2d_mapping(3))                    # head conv 3x3
    layers.append(conv2d_mapping(1))                    # head conv 1x1
    return stack_mapping(layers)


def vgg_cell8_mapping(padding: int = 1) -> CoordinateMapping:
    """The cell-8 VGG/SuperPoint backbone (SAME convs + 3 max-pools):
    scale 8, offset 3.5 (center of each 8x8 cell)."""
    layers = []
    for stage in range(4):
        layers += [conv2d_mapping(3, padding=padding)] * 2
        if stage < 3:
            layers.append(pool2d_mapping(2))
    return stack_mapping(layers)
