"""Optimizers and learning-rate schedules.

Counterpart of `ei_nexus_tpu/train/optim.py`: Adam (torch's coupled L2
weight decay, optax's add_decayed_weights then adam), SGD (decayed
weights, momentum, nesterov) and AdamW; the schedules StepLR, MultiStepLR,
ExponentialLR, CosineAnnealingLR, CosineAnnealingWarmRestarts, CyclicLR,
OneCycleLR (optax's cosine_onecycle_schedule, not torch's OneCycleLR) and
ReduceLROnPlateau (host-driven, `PlateauController`).

A schedule is the JAX package's closed form lr(step), with epoch = step //
steps_per_epoch, not one of torch's recursive schedulers; the training
step writes lr(step) into the optimizer before each update, as optax reads
the schedule at its update count. For ReduceLROnPlateau the schedule is
constant and the trainer writes the controller's lr between epochs
(`set_learning_rate`), which the step then leaves alone
(`is_host_driven`).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Iterable, Mapping

import numpy as np
import torch


def build_schedule(config: Mapping[str, Any], base_lr: float,
                   steps_per_epoch: int = 1) -> Callable[[int], float]:
    """Scheduler config -> lr(step), a host float."""
    stype = config.get("type", "CosineAnnealingLR")
    p = config.get(stype) or {}
    spe = max(steps_per_epoch, 1)

    if stype == "StepLR":
        step_size = p.get("step_size", 200)
        gamma = p.get("gamma", 0.1)
        return lambda step: base_lr * gamma ** ((step // spe) // step_size)
    if stype == "MultiStepLR":
        milestones = sorted(p.get("milestones", [10, 20, 30]))
        gamma = p.get("gamma", 0.1)
        return lambda step: base_lr * gamma ** sum(
            step // spe >= m for m in milestones)
    if stype == "ExponentialLR":
        gamma = p.get("gamma", 0.1)
        return lambda step: base_lr * gamma ** (step // spe)
    if stype == "CosineAnnealingLR":
        T_max = p.get("T_max", 50)
        eta_min = p.get("eta_min", 0.0)

        def cosine(step: int) -> float:
            epoch = min(step // spe, T_max)
            return eta_min + (base_lr - eta_min) * 0.5 * (
                1 + math.cos(math.pi * epoch / T_max))
        return cosine
    if stype == "CosineAnnealingWarmRestarts":
        T_0 = p.get("T_0", 10)
        T_mult = p.get("T_mult", 1)
        eta_min = p.get("eta_min", 0.0)

        def restarts(step: int) -> float:
            epoch = step // spe
            if T_mult == 1:
                t_i, t_cur = T_0, epoch % T_0
            else:
                # closed form for geometric restart lengths; the cycle
                # index in float32 as the JAX package computes it (float64
                # puts epoch 121 of T_0=1, T_mult=3 in cycle 4, not 5)
                n = int(np.floor(
                    np.log(np.float32(epoch * (T_mult - 1) / T_0 + 1))
                    / np.float32(math.log(T_mult))))
                start = T_0 * (T_mult ** n - 1) / (T_mult - 1)
                t_i = T_0 * T_mult ** n
                t_cur = epoch - start
            return eta_min + (base_lr - eta_min) * 0.5 * (
                1 + math.cos(math.pi * t_cur / t_i))
        return restarts
    if stype == "CyclicLR":
        lo = p.get("base_lr", base_lr / 10)
        hi = p.get("max_lr", base_lr)
        up = p.get("step_size_up", 2000)
        down = p.get("step_size_down") or up

        def cyclic(step: int) -> float:
            pos = step % (up + down)
            if pos < up:
                return lo + (hi - lo) * pos / up
            return hi - (hi - lo) * (pos - up) / down
        return cyclic
    if stype == "OneCycleLR":
        return _cosine_onecycle(
            p.get("total_steps") or (p.get("epochs", 10) * spe),
            p.get("max_lr", base_lr), p.get("pct_start", 0.3),
            p.get("div_factor", 25.0), p.get("final_div_factor", 1e4))
    if stype == "ReduceLROnPlateau":
        # host-driven: constant here, the trainer writes the plateau
        # controller's lr between epochs
        return lambda step: base_lr
    raise NotImplementedError(f"scheduler {stype!r}")


def _cosine_onecycle(total: int, peak: float, pct_start: float,
                     div_factor: float, final_div_factor: float
                     ) -> Callable[[int], float]:
    """optax.cosine_onecycle_schedule in closed form: from peak/div_factor
    up to peak over the first pct_start of `total` steps, then down to
    (peak/div_factor)/final_div_factor, each leg a half cosine, constant
    after `total`."""
    if total <= 0:
        raise ValueError("OneCycleLR needs a positive step count")
    # optax's piecewise_interpolate_schedule: values are the running
    # products of the initial value and the scales at each boundary
    scales = {int(pct_start * total): div_factor,
              int(total): 1.0 / (div_factor * final_div_factor)}
    bounds = [0] + sorted(scales)
    values = [peak / div_factor]
    for b in bounds[1:]:
        values.append(values[-1] * scales[b])

    def onecycle(step: int) -> float:
        for i in range(len(bounds) - 1):
            if bounds[i] <= step < bounds[i + 1]:
                frac = (step - bounds[i]) / (bounds[i + 1] - bounds[i])
                return values[i + 1] + (values[i] - values[i + 1]) / 2.0 * (
                    math.cos(math.pi * frac) + 1)
        return values[-1]
    return onecycle


def is_host_driven(config: Mapping[str, Any]) -> bool:
    """True for scheduler types whose lr the trainer sets between steps on
    the host (ReduceLROnPlateau) rather than computing it from the step."""
    return config.get("type") == "ReduceLROnPlateau"


class PlateauController:
    """Host-side ReduceLROnPlateau with torch's semantics (a copy of the
    JAX package's controller): call `step(metric)` once an epoch and write
    the returned lr into the optimizer with `set_learning_rate`. After
    `patience` epochs without a `threshold`-sized improvement, lr *=
    factor (clamped at min_lr, skipped when the change is below eps), then
    `cooldown` epochs in which bad epochs are not counted."""

    def __init__(self, base_lr: float, mode: str = "min",
                 factor: float = 0.1, patience: int = 10,
                 threshold: float = 1e-4, threshold_mode: str = "rel",
                 cooldown: int = 0, min_lr: float = 0.0,
                 eps: float = 1e-8):
        if mode not in ("min", "max") or threshold_mode not in ("rel",
                                                                "abs"):
            raise ValueError(f"mode {mode!r}, threshold_mode "
                             f"{threshold_mode!r}")
        if factor >= 1.0:
            raise ValueError(f"factor {factor} must be < 1")
        self.lr = float(base_lr)
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.eps = eps
        self.best = math.inf if mode == "min" else -math.inf
        self.num_bad_epochs = 0
        self.cooldown_counter = 0

    @classmethod
    def from_config(cls, config: Mapping[str, Any], base_lr: float
                    ) -> "PlateauController":
        p = config.get("ReduceLROnPlateau") or {}
        return cls(base_lr, mode=p.get("mode", "min"),
                   factor=p.get("factor", 0.1),
                   patience=p.get("patience", 10),
                   threshold=p.get("threshold", 1e-4),
                   threshold_mode=p.get("threshold_mode", "rel"),
                   cooldown=p.get("cooldown", 0),
                   min_lr=p.get("min_lr", 0.0), eps=p.get("eps", 1e-8))

    def _is_better(self, a: float, best: float) -> bool:
        if self.mode == "min":
            if self.threshold_mode == "rel":
                return a < best * (1.0 - self.threshold)
            return a < best - self.threshold
        if self.threshold_mode == "rel":
            return a > best * (1.0 + self.threshold)
        return a > best + self.threshold

    def step(self, metric: float) -> float:
        """Record one epoch's monitored metric; returns the (possibly
        reduced) learning rate."""
        current = float(metric)
        if self._is_better(current, self.best):
            self.best = current
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0
        if self.num_bad_epochs > self.patience:
            new_lr = max(self.lr * self.factor, self.min_lr)
            if self.lr - new_lr > self.eps:
                self.lr = new_lr
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0
        return self.lr

    def state_dict(self) -> Dict[str, Any]:
        return {"lr": self.lr, "best": self.best,
                "num_bad_epochs": self.num_bad_epochs,
                "cooldown_counter": self.cooldown_counter}

    def load_state_dict(self, sd: Mapping[str, Any]) -> None:
        self.lr = float(sd["lr"])
        self.best = float(sd["best"])
        self.num_bad_epochs = int(sd["num_bad_epochs"])
        self.cooldown_counter = int(sd["cooldown_counter"])


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Write `lr` into every parameter group of `optimizer`."""
    for group in optimizer.param_groups:
        group["lr"] = lr


def get_learning_rate(optimizer: torch.optim.Optimizer) -> float:
    """The learning rate of the first parameter group."""
    return float(optimizer.param_groups[0]["lr"])


def build_optimizer(config: Mapping[str, Any],
                    params: Iterable[torch.nn.Parameter],
                    schedule: Callable[[int], float]
                    ) -> torch.optim.Optimizer:
    """Optimizer config -> torch optimizer over `params`, at lr(0). Each
    type computes the update of the JAX package's optax chain:
     - Adam: weight_decay is coupled L2 (the gradient plus wd * p, then
       Adam), torch's Adam(weight_decay=);
     - AdamW: decoupled decay, p -= lr * wd * p;
     - SGD: the gradient plus wd * p, then momentum (no dampening; the
       first step's buffer is the gradient, as optax's trace from 0) and
       optionally nesterov."""
    otype = config.get("type", "AdamW")
    p = config.get(otype) or {}
    lr = schedule(0)
    if otype in ("Adam", "AdamW"):
        betas = p.get("betas", [0.9, 0.999])
        cls = torch.optim.Adam if otype == "Adam" else torch.optim.AdamW
        wd = float(p.get("weight_decay", 0.0 if otype == "Adam" else 1e-5))
        return cls(params, lr=lr, betas=(betas[0], betas[1]),
                   eps=float(p.get("eps", 1e-8)), weight_decay=wd)
    if otype == "SGD":
        return torch.optim.SGD(params, lr=lr,
                               momentum=p.get("momentum", 0.9),
                               nesterov=p.get("nesterov", False),
                               weight_decay=float(p.get("weight_decay", 0.0)))
    raise NotImplementedError(f"optimizer {otype!r}")
