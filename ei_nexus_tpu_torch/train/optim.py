"""Optimizer and learning-rate schedule.

Counterpart of `ei_nexus_tpu/train/optim.py` for stage 2's configuration
(configs/train/train_stage2.yaml): AdamW and CosineAnnealingLR. The
schedule is the JAX package's closed form, lr(step) with epoch =
step // steps_per_epoch, not torch's recursive CosineAnnealingLR; the
training step writes lr(step) into the optimizer before each update, as
optax reads the schedule at its update count. Other optimizer and
schedule types raise NotImplementedError until their slice.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Iterable, Mapping

import torch


def build_schedule(config: Mapping[str, Any], base_lr: float,
                   steps_per_epoch: int = 1) -> Callable[[int], float]:
    """Scheduler config -> lr(step), a host float."""
    stype = config.get("type", "CosineAnnealingLR")
    if stype != "CosineAnnealingLR":
        raise NotImplementedError(f"scheduler {stype!r} is not ported yet")
    p = config.get(stype) or {}
    T_max = p.get("T_max", 50)
    eta_min = p.get("eta_min", 0.0)
    spe = max(steps_per_epoch, 1)

    def sched(step: int) -> float:
        epoch = min(step // spe, T_max)
        return eta_min + (base_lr - eta_min) * 0.5 * (
            1 + math.cos(math.pi * epoch / T_max))
    return sched


def build_optimizer(config: Mapping[str, Any],
                    params: Iterable[torch.nn.Parameter],
                    schedule: Callable[[int], float]
                    ) -> torch.optim.Optimizer:
    """Optimizer config -> torch optimizer over `params`, at lr(0)."""
    otype = config.get("type", "AdamW")
    if otype != "AdamW":
        raise NotImplementedError(f"optimizer {otype!r} is not ported yet")
    p = config.get(otype) or {}
    betas = p.get("betas", [0.9, 0.999])
    return torch.optim.AdamW(params, lr=schedule(0),
                             betas=(betas[0], betas[1]),
                             eps=float(p.get("eps", 1e-8)),
                             weight_decay=float(p.get("weight_decay", 1e-5)))
