"""Parameter freezing.

Counterpart of `ei_nexus_tpu/train/partition.py`. The JAX package zeroes
the gradients of frozen top-level subtrees; here the frozen roots' parameters
get `requires_grad=False`, stay out of the optimizer, and `check_frozen`
verifies after a backward that none of them received a gradient.
"""

from __future__ import annotations

from typing import Iterable, List, Set

import torch
import torch.nn as nn


def frozen_roots_from_config(config) -> Set[str]:
    """EIMConfig -> the set of frozen top-level module names."""
    roots = set()
    if config.event_extractor.freeze:
        roots.add("event_extractor")
    if config.image_extractor.freeze:
        roots.add("image_extractor")
    if config.matcher.freeze:
        roots.add("matcher")
    return roots


def freeze(model: nn.Module, roots: Iterable[str]) -> List[nn.Parameter]:
    """Set requires_grad=False under the frozen roots; returns the
    trainable parameters (everything else), in module order."""
    roots = set(roots)
    trainable = []
    for name, p in model.named_parameters():
        frozen = name.split(".")[0] in roots
        p.requires_grad_(not frozen)
        if not frozen:
            trainable.append(p)
    return trainable


def check_frozen(model: nn.Module, roots: Iterable[str]) -> None:
    """Raise if a parameter under a frozen root holds a gradient (a host
    check of the .grad attributes; no device synchronisation)."""
    roots = set(roots)
    for name, p in model.named_parameters():
        if name.split(".")[0] in roots and (p.requires_grad
                                            or p.grad is not None):
            raise RuntimeError(f"frozen parameter {name} is trainable or "
                               f"received a gradient")
