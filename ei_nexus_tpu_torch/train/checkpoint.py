"""Checkpoints with `torch.save`, the import of other formats, and the
surgery between stages.

Counterpart of `ei_nexus_tpu/train/checkpoint.py` (orbax there). A
checkpoint is a directory holding `state.pt`: the model's state dict
(parameters and BatchNorm statistics), the optimizer's state dict, `step`
and `epoch`; the trainer may write sidecars beside it (the plateau
controller's `plateau.json`). The stage surgery copies one subtree of a
checkpoint into a model: a stage-1 checkpoint's event extractor
(parameters and running statistics) and a stage-2 checkpoint's matcher
(parameters only), the reference's key-prefix surgery.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn as nn

STATE_FILE = "state.pt"


def save_checkpoint(ckpt_dir: str, state, epoch: int,
                    name: Optional[str] = None) -> str:
    """Save {model, optimizer, step, epoch} to <ckpt_dir>/<name>/state.pt
    (name: checkpoint_<epoch> by default); returns the directory. The
    file is written beside and renamed into place, so a checkpoint is
    whole or absent."""
    name = name or f"checkpoint_{epoch}"
    path = os.path.abspath(os.path.join(ckpt_dir, name))
    os.makedirs(path, exist_ok=True)
    payload = {
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "step": int(state.step),
        "epoch": int(epoch),
    }
    tmp = os.path.join(path, STATE_FILE + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    return path


def _load(path: str) -> Dict[str, Any]:
    """A checkpoint's payload, its tensors on the CPU. Only checkpoints this
    package wrote are read (`weights_only`: tensors and plain containers)."""
    return torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                      weights_only=True)


def restore_checkpoint(path: str, state, params_only: bool = False
                       ) -> Tuple[Any, int]:
    """Restore a checkpoint into `state` in place (the model's tensors keep
    their device); returns (state, epoch). `params_only` skips the
    optimizer's state, for a caller whose optimizer differs from the
    training one (the evaluation entry points)."""
    raw = _load(path)
    state.model.load_state_dict(raw["model"], strict=True)
    if not params_only:
        state.optimizer.load_state_dict(raw["optimizer"])
    state.step = int(raw["step"])
    return state, int(raw["epoch"])


def restore_any_checkpoint(path: str, state, model_config):
    """A checkpoint directory of this package; a reference `.pth` / `.pt`
    state dict of a whole EIM (the released-checkpoint layout), read
    through `models/port_torch.py` into `state.model` as the reference's
    `strict=False` load does; or an `.npz` exported from a JAX run
    (`tools/export_jax_checkpoint.py`), carried across by
    `models/port_jax.py` and loaded with `strict=True`. Returns (state,
    epoch), epoch 0 for a `.pth` or `.npz` (they carry no trainer state).
    `model_config` is the model's `EIMConfig`."""
    if str(path).endswith(".npz"):
        from ..models.port_jax import load_jax_npz
        state.model.load_state_dict(load_jax_npz(path), strict=True)
        return state, 0
    if str(path).endswith((".pth", ".pt")):
        from ..models.port_torch import load_eim_checkpoint_file
        cfg = model_config
        load_eim_checkpoint_file(
            path, state.model,
            image_extractor_type=cfg.image_extractor.type,
            matcher_type=cfg.matcher.type,
            n_lightglue_layers=cfg.matcher.lightglue.n_layers,
            use_batchnorm=cfg.event_extractor.use_batchnorm)
        return state, 0
    return restore_checkpoint(path, state, params_only=True)


def _subtree(sd: Dict[str, torch.Tensor], root: str,
             params_only: bool = False) -> Dict[str, torch.Tensor]:
    stats = ("running_mean", "running_var")
    return {k: v for k, v in sd.items() if k.split(".")[0] == root
            and not (params_only and k.endswith(stats))}


def _copy_subtree(path: str, model: nn.Module, root: str,
                  params_only: bool) -> nn.Module:
    have = _subtree(_load(path)["model"], root, params_only)
    want = _subtree(model.state_dict(), root, params_only)
    if set(want) - set(have):
        raise KeyError(f"the checkpoint lacks "
                       f"{sorted(set(want) - set(have))[:5]}")
    model.load_state_dict({k: have[k] for k in want}, strict=False)
    return model


def load_stage1_event_extractor(path: str, model: nn.Module) -> nn.Module:
    """Copy a stage-1 checkpoint's event extractor, parameters and
    BatchNorm running statistics, into `model`, in place."""
    return _copy_subtree(path, model, "event_extractor", params_only=False)


def load_stage2_matcher(path: str, model: nn.Module) -> nn.Module:
    """Copy a stage-2 checkpoint's matcher parameters into `model`, in
    place (the training heads a checkpoint may hold beyond the model's
    are left out)."""
    return _copy_subtree(path, model, "matcher", params_only=True)
