"""Training state.

Counterpart of `ei_nexus_tpu/train/state.py`. The JAX TrainState is an
immutable pytree that each step replaces; this one holds the model, the
optimizer, the schedule, the frozen roots and the step count, and the
training step updates it IN PLACE (parameters, optimizer moments, step).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterable, List, Mapping, Set

import torch
import torch.nn as nn

from .optim import build_optimizer, build_schedule
from .partition import freeze


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    frozen_roots: Set[str]
    trainable: List[nn.Parameter]
    step: int = 0


def create_train_state(model: nn.Module, frozen_roots: Iterable[str],
                       optimizer: Mapping[str, Any],
                       scheduler: Mapping[str, Any], base_lr: float,
                       steps_per_epoch: int = 1) -> TrainState:
    """Freeze `frozen_roots` and build the optimizer over the rest."""
    roots = set(frozen_roots)
    trainable = freeze(model, roots)
    schedule = build_schedule(scheduler, base_lr, steps_per_epoch)
    return TrainState(model=model,
                      optimizer=build_optimizer(optimizer, trainable,
                                                schedule),
                      schedule=schedule, frozen_roots=roots,
                      trainable=trainable)
