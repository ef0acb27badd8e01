"""Shared compute kernels: padding, NMS, keypoint selection, descriptor
sampling and the fused attention kernels. Counterpart of
`ei_nexus_tpu/ops/`; the TPU kernels are CUDA kernels here, each beside its
plain PyTorch version (`nms_kernel.py`, `attention_kernels.py`,
`flash_kernel.py`)."""

from .pad import Padder
from .detector import (
    logits_to_prob,
    depth_to_space,
    remove_border_scores,
    nms,
    select_topk_keypoints,
    smooth_score_mask,
    dense_positions,
)
from .descriptor import (
    normalize_descriptors,
    sample_descriptors_lowres,
    sample_descriptors_fullres,
    upsample_descriptors,
    dense_descriptors,
)
from .attention_kernels import qblock_attention
from .flash_kernel import flash_attention, segment_ids_from_mask

__all__ = [
    "Padder",
    "logits_to_prob", "depth_to_space", "remove_border_scores", "nms",
    "select_topk_keypoints", "smooth_score_mask", "dense_positions",
    "normalize_descriptors", "sample_descriptors_lowres",
    "sample_descriptors_fullres", "upsample_descriptors",
    "dense_descriptors",
    "qblock_attention", "flash_attention", "segment_ids_from_mask",
]
