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
(`stage1_train_state`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch

from .device import resolve_device
from .train.partition import frozen_roots_from_config
from .train.state import TrainState, create_train_state
from .models.eim import EIM, EIMConfig, ExtractorSpec, MatcherConfig
from .models.extractor import KeypointExtractorConfig
from .models.layers import init_parameters
from .models.lightglue import LightGlueConfig


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
                    attention_impl: str = "auto", block_q: int = 0
                    ) -> Tuple[EIMConfig, Tuple[int, int, int]]:
    """(EIMConfig, (H, W, bins)) of the flagship, LightGlue's attention
    taken as `attention_impl` with q blocks of `block_q` rows."""
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
                attention_impl=attention_impl, block_q=block_q)))
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
                  pad_mode: str = "random"
                  ) -> Tuple[EIMConfig, Tuple[int, int, int]]:
    """The flagship with its event extractor frozen (both extractors
    frozen, LightGlue trained): stage 2."""
    cfg, shape = flagship_config(tiny, dtype)
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
