"""Model zoo of the port: VGG blocks, the cell-8 event extractor,
SuperPoint v1, LightGlue (inference and training) and the composite EIM. Counterpart of
`ei_nexus_tpu/models/`; NHWC at the public functions."""

from .vgg import VGGBlock, VGGBackbone, VGGDetectorHead, VGGDescriptorHead
from .extractor import KeypointExtractorConfig, VGGExtractor, extract_keypoints
from .superpoint import SuperPointV1
from .lightglue import LightGlue, LightGlueConfig
from .eim import EIM, EIMConfig, ExtractorSpec, MatcherConfig, build_model
from .port_jax import load_jax_variables

__all__ = [
    "VGGBlock", "VGGBackbone", "VGGDetectorHead", "VGGDescriptorHead",
    "KeypointExtractorConfig", "VGGExtractor", "extract_keypoints",
    "SuperPointV1", "LightGlue", "LightGlueConfig",
    "EIM", "EIMConfig", "ExtractorSpec", "MatcherConfig", "build_model",
    "load_jax_variables",
]
