"""The flagship model: EIM (event VGG extractor + SuperPoint v1 + LightGlue)
at MVSEC scale, the configuration the JAX package's benchmark times.

Counterpart of `__graft_entry__._flagship`, with the same shapes: full is
260x346, 16 bins, K=1024, feature width 128, descriptors 256, 9 LightGlue
layers of 4 heads; tiny is 32x48, 4 bins, K=32, width 16, descriptors 32,
2 layers. `attention_impl` and `block_q` are the counterparts of
`_flagship`'s EI_NEXUS_ATTN and EI_NEXUS_ATTN_QBLOCK: "auto" (kernels A and
B, or kernel E with block_q 64 or 128), "flash" (kernel G) or "xla". Its
stage-2 variant (`build_stage2_flagship`) freezes the event
extractor as tools/bench_train.py does and trains LightGlue with the
optimizer of configs/train/train_stage2.yaml (`stage2_train_state`). Its
stage-1 variant (`build_stage1_flagship`, tools/bench_train.py:44-56)
trains the event extractor against the frozen SuperPoint with the frozen
MNN matcher, the losses of tools/bench_train.py:84-99 (`STAGE1_LOSSES`)
and the optimizer of configs/train/train_stage1.yaml
(`stage1_train_state`). `silk_config` reads the SiLK family's model
configs (the cell-1 event extractor `vgg_np` and the frozen SiLK, with
LightGlue or MNN, or SiLK on both frames) at the same sizes.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional, Tuple, Union

import torch

from .device import resolve_device
from .train.partition import frozen_roots_from_config
from .train.state import TrainState, create_train_state
from .models.config_adapter import eim_config_from_dict
from .models.eim import (EIM, EIMConfig, ExtractorSpec, ImageImageMatcher,
                         MatcherConfig)
from .models.extractor import KeypointExtractorConfig
from .models.layers import init_parameters
from .models.lightglue import LightGlueConfig
from .utils.config import load_config


# configs/train/train_stage2.yaml
STAGE2_OPTIMIZER = {"type": "AdamW",
                    "AdamW": {"weight_decay": 1e-5, "betas": [0.9, 0.999],
                              "eps": 1e-8}}
STAGE2_SCHEDULER = {"type": "CosineAnnealingLR",
                    "CosineAnnealingLR": {"T_max": 50, "eta_min": 1e-7}}
STAGE2_LR = 1e-4

# configs/train/train_stage1.yaml
STAGE1_OPTIMIZER = {"type": "AdamW",
                    "AdamW": {"weight_decay": 1e-5, "betas": [0.9, 0.999],
                              "eps": 1e-8}}
STAGE1_SCHEDULER = {"type": "CosineAnnealingLR",
                    "CosineAnnealingLR": {"T_max": 50, "eta_min": 1e-7}}
STAGE1_LR = 1e-3
# tools/bench_train.py:84-99
STAGE1_LOSSES = {
    "keypoints_loss": {"type": "ScoreLoss",
                       "ScoreLoss": {"weight": 1.0, "mode": "mse",
                                     "use_mask": True}},
    "descriptors_loss": {"type": "DescriptorsLoss",
                         "DescriptorsLoss": {"mode": "mae", "weight": 1.0,
                                             "use_mask": True}},
    "feature_loss": {"type": "FeatureLoss",
                     "FeatureLoss": {"mode": "mse", "weight": 1.0}},
}


def flagship_config(tiny: bool = False, dtype: str = "bfloat16",
                    attention_impl: str = "auto", block_q: int = 0,
                    shard_heads: bool = False
                    ) -> Tuple[EIMConfig, Tuple[int, int, int]]:
    """(EIMConfig, (H, W, bins)) of the flagship, LightGlue's attention
    taken as `attention_impl` with q blocks of `block_q` rows, its heads
    split over a mesh's model group with `shard_heads` (as
    `_flagship(shard_heads=)`)."""
    if tiny:
        H, W, bins, K, feat, desc, layers = 32, 48, 4, 32, 16, 32, 2
    else:
        H, W, bins, K, feat, desc, layers = 260, 346, 16, 1024, 128, 256, 9
    kcfg = KeypointExtractorConfig(detection_top_k=K)
    cfg = EIMConfig(
        event_extractor=ExtractorSpec(
            type="vgg", in_channels=bins, feat_channels=feat,
            descriptor_dim=desc, lat_channels=max(feat * 2, 32),
            dtype=dtype, keypoints=kcfg),
        image_extractor=ExtractorSpec(
            type="superpointv1", freeze=True, descriptor_dim=desc,
            dtype=dtype, keypoints=kcfg),
        matcher=MatcherConfig(
            type="LightGlue", freeze=False, max_points_num=K,
            lightglue=LightGlueConfig(
                input_dim=desc, descriptor_dim=desc, n_layers=layers,
                num_heads=4, dtype=dtype, score_dtype=dtype,
                attention_impl=attention_impl, block_q=block_q,
                shard_heads=shard_heads)))
    return cfg, (H, W, bins)


def build_flagship(tiny: bool = False, dtype: str = "bfloat16",
                   device: Optional[Union[str, torch.device]] = "cuda",
                   generator: Optional[torch.Generator] = None,
                   attention_impl: str = "auto", block_q: int = 0
                   ) -> Tuple[EIM, Tuple[int, int, int]]:
    """(model in eval mode on `device`, (H, W, bins)); `attention_impl`
    and `block_q` as `flagship_config`.

    The weights are random, drawn with flax's default initialisers from
    `generator` (a CPU generator; seed 0 when None) before the model moves
    to `device`, so one seed gives the same weights on every device."""
    dev = resolve_device(device)
    cfg, shape = flagship_config(tiny, dtype, attention_impl, block_q)
    model = EIM(cfg)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    init_parameters(model, generator)
    return model.to(dev).eval(), shape


def stage2_config(tiny: bool = False, dtype: str = "bfloat16",
                  pad_mode: str = "random", shard_heads: bool = False
                  ) -> Tuple[EIMConfig, Tuple[int, int, int]]:
    """The flagship with its event extractor frozen (both extractors
    frozen, LightGlue trained): stage 2."""
    cfg, shape = flagship_config(tiny, dtype, shard_heads=shard_heads)
    return dataclasses.replace(
        cfg,
        event_extractor=dataclasses.replace(cfg.event_extractor, freeze=True),
        matcher=dataclasses.replace(cfg.matcher, pad_mode=pad_mode)), shape


def build_stage2_flagship(tiny: bool = False, dtype: str = "bfloat16",
                          device: Optional[Union[str, torch.device]] = "cuda",
                          generator: Optional[torch.Generator] = None
                          ) -> Tuple[EIM, Tuple[int, int, int]]:
    """(stage-2 model on `device` with LightGlue's training heads,
    (H, W, bins)); weights random from `generator` as `build_flagship`."""
    dev = resolve_device(device)
    cfg, shape = stage2_config(tiny, dtype)
    model = EIM(cfg, training_heads=True)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    init_parameters(model, generator)
    return model.to(dev), shape


def stage2_train_state(model: EIM, steps_per_epoch: int = 1) -> TrainState:
    """Freeze the config's frozen roots and build stage 2's AdamW with its
    cosine schedule over the rest."""
    return create_train_state(model, frozen_roots_from_config(model.config),
                              STAGE2_OPTIMIZER, STAGE2_SCHEDULER, STAGE2_LR,
                              steps_per_epoch)


def stage1_config(tiny: bool = False, dtype: str = "bfloat16"
                  ) -> Tuple[EIMConfig, Tuple[int, int, int]]:
    """The flagship with its event extractor trainable, SuperPoint frozen
    and the frozen MNN matcher at max_points_num K (stage 1)."""
    cfg, shape = flagship_config(tiny, dtype)
    return dataclasses.replace(
        cfg,
        event_extractor=dataclasses.replace(cfg.event_extractor,
                                            freeze=False),
        matcher=MatcherConfig(type="MNN", freeze=True,
                              max_points_num=cfg.matcher.max_points_num)
    ), shape


def build_stage1_flagship(tiny: bool = False, dtype: str = "bfloat16",
                          device: Optional[Union[str, torch.device]] = "cuda",
                          generator: Optional[torch.Generator] = None
                          ) -> Tuple[EIM, Tuple[int, int, int]]:
    """(stage-1 model on `device`, (H, W, bins)); weights random from
    `generator` as `build_flagship`."""
    dev = resolve_device(device)
    cfg, shape = stage1_config(tiny, dtype)
    model = EIM(cfg)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    init_parameters(model, generator)
    return model.to(dev), shape


def stage1_train_state(model: EIM, steps_per_epoch: int = 1) -> TrainState:
    """Freeze the config's frozen roots and build stage 1's AdamW with its
    cosine schedule over the rest (the event extractor)."""
    return create_train_state(model, frozen_roots_from_config(model.config),
                              STAGE1_OPTIMIZER, STAGE1_SCHEDULER, STAGE1_LR,
                              steps_per_epoch)


CONFIGS = Path(__file__).resolve().parent.parent / "configs" / "model"
# the SiLK family's model configs: name -> (YAML, model type)
SILK_CONFIGS = {
    "EI_SiLK_LG": ("test/EI_SiLK_LG.yaml", "EIM"),
    "EI_SiLK_MNN": ("test/EI_SiLK_MNN.yaml", "EIM"),
    "EIM_stage2_SiLK_LG": ("EIM_stage2_SiLK_LG.yaml", "EIM"),
    "SiLK_MNN": ("SiLK_MNN.yaml", "EIM"),
    "SiLKMatcher": ("SiLKMatcher.yaml", "ImageImageMatcher"),
}


def silk_model_dict(tiny: bool = False, dtype: str = "bfloat16",
                    name: str = "EI_SiLK_LG"
                    ) -> Tuple[dict, Tuple[int, int, int]]:
    """(model config dict, (H, W, bins)) of one SiLK-family model config
    (`SILK_CONFIGS`), read through the config loader. Only the compute
    dtype of the extractors and LightGlue is overridden, and at `tiny` the
    sizes: 32x48, 4 bins, 32 matcher slots with the config's ratio of
    keypoints to slots (512 of 1024 -> 16 of 32), 2 LightGlue layers; the
    widths (LightGlue's input_dim 128 included) stay. Full size is MVSEC's
    260x346 at the config's 16 bins."""
    path = str(CONFIGS / SILK_CONFIGS[name][0])
    raw = load_config(path).to_dict()
    overrides = [f"event_extractor.dtype={dtype}",
                 f"image_extractor.dtype={dtype}", f"matcher.dtype={dtype}"]
    ev_type = raw["event_extractor"]["type"]
    slots = raw["matcher"].get("max_points_num", 1024)
    if tiny:
        H, W, bins, K = 32, 48, 4, 32
        overrides += [f"event_extractor.{ev_type}.in_channels={bins}",
                      f"matcher.max_points_num={K}",
                      "matcher.LightGlue.n_layers=2"]
        for side in ("event_extractor", "image_extractor"):
            etype = raw[side]["type"]
            top_k = raw[side].get(etype, {}).get("detection_top_k", 1024)
            overrides.append(f"{side}.{etype}.detection_top_k="
                             f"{top_k * K // slots}")
    else:
        H, W = 260, 346
        bins = raw["event_extractor"].get(ev_type, {}).get("in_channels", 16)
    return load_config(path, overrides).to_dict(), (H, W, bins)


def silk_config(tiny: bool = False, dtype: str = "bfloat16",
                name: str = "EI_SiLK_LG"
                ) -> Tuple[EIMConfig, Tuple[int, int, int]]:
    """(EIMConfig, (H, W, bins)) of `silk_model_dict` through the config
    adapter; the model type to build is `SILK_CONFIGS[name][1]`."""
    model_dict, shape = silk_model_dict(tiny, dtype, name)
    return eim_config_from_dict(model_dict), shape


def build_silk(name: str = "EI_SiLK_LG", tiny: bool = False,
               dtype: str = "bfloat16",
               device: Optional[Union[str, torch.device]] = "cuda",
               generator: Optional[torch.Generator] = None,
               training_heads: bool = False, **spec
               ) -> Tuple[torch.nn.Module, Tuple[int, int, int]]:
    """(model of `silk_config(tiny, dtype, name)` in eval mode on
    `device`, (H, W, bins)): an EIM or an ImageImageMatcher as
    `SILK_CONFIGS` says, with LightGlue's training heads when
    `training_heads`; `spec` replaces fields of both extractors' specs
    (e.g. padding=0). Weights random from `generator` as
    `build_flagship`."""
    dev = resolve_device(device)
    cfg, shape = silk_config(tiny, dtype, name)
    if spec:
        cfg = dataclasses.replace(cfg, **{
            side: dataclasses.replace(getattr(cfg, side), **spec)
            for side in ("event_extractor", "image_extractor")})
    cls = EIM if SILK_CONFIGS[name][1] == "EIM" else ImageImageMatcher
    model = cls(cfg, training_heads)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    init_parameters(model, generator)
    return model.to(dev).eval(), shape
