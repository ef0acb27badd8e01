"""Mapping from YAML model configs (configs/model/*.yaml) to the typed
model dataclasses.

A copy of `ei_nexus_tpu/models/config_adapter.py`: every extractor type of
the configs ("vgg", "vgg_np", "superpointv1", "silk") maps to its spec,
and `build_model` builds each of them."""

from __future__ import annotations

from typing import Any, Mapping

from .extractor import KeypointExtractorConfig
from .lightglue import LightGlueConfig
from .eim import EIMConfig, ExtractorSpec, MatcherConfig


def _keypoint_cfg(p: Mapping[str, Any], cell_size: int,
                  sparse_from: str, smooth_mask: bool,
                  coord_offset: float = 0.0) -> KeypointExtractorConfig:
    return KeypointExtractorConfig(
        cell_size=cell_size,
        nms_radius=p.get("nms_radius", 4),
        detection_top_k=p.get("detection_top_k", 1024),
        detection_threshold=p.get("detection_threshold", 1.0),
        remove_borders=p.get("remove_borders", 4),
        ordering=p.get("ordering", "yx"),
        descriptor_scale_factor=p.get("descriptor_scale_factor", 1.0),
        smooth_mask=smooth_mask,
        coord_offset=coord_offset,
        sparse_desc_from=sparse_from,
    )


def _extractor_spec(section: Mapping[str, Any], default_in_channels: int = 16
                    ) -> ExtractorSpec:
    etype = section["type"]
    p = section.get(etype, {})
    freeze = section.get("freeze", False)
    padding = p.get("padding", 1)
    if etype == "vgg":
        kcfg = _keypoint_cfg(p, cell_size=8, sparse_from="lowres",
                             smooth_mask=True)
    elif etype == "vgg_np":
        kcfg = _keypoint_cfg(p, cell_size=1, sparse_from="fullres",
                             smooth_mask=True,
                             coord_offset=9.0 if padding == 0 else 0.0)
    elif etype == "superpointv1":
        kcfg = _keypoint_cfg(p, cell_size=8, sparse_from="lowres",
                             smooth_mask=False)
    elif etype == "silk":
        kcfg = _keypoint_cfg(p, cell_size=1, sparse_from="fullres",
                             smooth_mask=False,
                             coord_offset=9.0 if padding == 0 else 0.0)
    else:
        raise ValueError(f"unknown extractor type {etype!r}")
    return ExtractorSpec(
        type=etype,
        freeze=freeze,
        dtype=p.get("dtype", section.get("dtype", "float32")),
        in_channels=p.get("in_channels", default_in_channels),
        feat_channels=p.get("feat_channels", 128),
        descriptor_dim=p.get("descriptor_dim",
                             128 if etype in ("silk", "vgg_np") else 256),
        lat_channels=p.get("lat_channels",
                           128 if etype == "silk" else 256),
        use_batchnorm=p.get("use_batchnorm", True),
        padding=padding,
        keypoints=kcfg,
    )


def eim_config_from_dict(model_cfg: Mapping[str, Any]) -> EIMConfig:
    """configs/model/EIM_*.yaml section -> EIMConfig."""
    m = model_cfg["matcher"]
    lg = m.get("LightGlue", {})
    matcher = MatcherConfig(
        type=m.get("type"),
        freeze=m.get("freeze", True),
        max_points_num=m.get("max_points_num", 1024),
        pad_mode=m.get("pad_mode", "random"),
        desc_scale_factor=m.get("desc_scale_factor", 1.0),
        ratio_thresh=m.get("MNN", {}).get("ratio_thresh") or None,
        distance_thresh=m.get("MNN", {}).get("distance_thresh") or None,
        lightglue=LightGlueConfig(
            dtype=lg.get("dtype", m.get("dtype", "float32")),
            score_dtype=lg.get("score_dtype",
                               lg.get("dtype", m.get("dtype", "float32"))),
            input_dim=lg.get("input_dim", 256),
            descriptor_dim=lg.get("descriptor_dim", 256),
            n_layers=lg.get("n_layers", 9),
            num_heads=lg.get("num_heads", 4),
            filter_threshold=lg.get("filter_threshold", 0.0),
            gamma=lg.get("loss", {}).get("gamma", 1.0),
            nll_balancing=lg.get("loss", {}).get("nll_balancing", 0.5),
            # adaptive inference (reference lightglue.py:431-432)
            depth_confidence=lg.get("depth_confidence", -1.0),
            width_confidence=lg.get("width_confidence", -1.0),
        ),
    )
    return EIMConfig(
        event_extractor=_extractor_spec(model_cfg["event_extractor"]),
        image_extractor=_extractor_spec(model_cfg["image_extractor"],
                                        default_in_channels=1),
        matcher=matcher,
    )
