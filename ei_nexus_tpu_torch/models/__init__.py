"""Model zoo of the port: VGG blocks, the cell-8 and cell-1 event
extractors, SuperPoint v1, SiLK, LightGlue (inference and training), the
MNN matcher, the composite EIM and ImageImageMatcher, the PointNet++
blocks (`pointnet`), and the weight imports: from JAX variables
(`port_jax`) and from the reference's `.pth` files (`port_torch`).
Counterpart of `ei_nexus_tpu/models/`; NHWC at the public functions."""

from .vgg import VGGBlock, VGGBackbone, VGGDetectorHead, VGGDescriptorHead
from .extractor import KeypointExtractorConfig, VGGExtractor, extract_keypoints
from .superpoint import SuperPointV1
from .silk import SiLKVGG, load_silk_state_dict
from .lightglue import LightGlue, LightGlueConfig
from .mnn import gather_matched_keypoints, mnn_match
from .eim import (EIM, EIMConfig, ExtractorSpec, ImageImageMatcher,
                  MatcherConfig, build_model)
from .port_jax import load_jax_variables

__all__ = [
    "VGGBlock", "VGGBackbone", "VGGDetectorHead", "VGGDescriptorHead",
    "KeypointExtractorConfig", "VGGExtractor", "extract_keypoints",
    "SuperPointV1", "SiLKVGG", "load_silk_state_dict",
    "LightGlue", "LightGlueConfig",
    "mnn_match", "gather_matched_keypoints",
    "EIM", "EIMConfig", "ExtractorSpec", "ImageImageMatcher",
    "MatcherConfig", "build_model",
    "load_jax_variables",
]
