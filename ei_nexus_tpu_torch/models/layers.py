"""Counterparts of the flax layers the JAX package builds on (nn.Dense,
nn.Conv, nn.BatchNorm, nn.LayerNorm) with flax's dtype semantics: the
parameters stay float32 and are cast to the compute dtype at use; norms
reduce in float32 and return the compute dtype. Initialisation follows
flax's defaults (truncated lecun-normal kernels, zero biases) from an
explicit `torch.Generator`. Convolutions take NCHW tensors.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.linear_kernel import linear_route, linear_tf32, weight_planes
from ..parallel.collectives import all_reduce_sum
from ..parallel.mesh import data_group


def _lecun_normal_(w: torch.Tensor, generator=None) -> None:
    """flax's default kernel init: variance_scaling(1, fan_in,
    truncated_normal), cut at two standard deviations."""
    std = math.sqrt(1.0 / w[0].numel()) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                          generator=generator)


class Linear(nn.Linear):
    """flax nn.Dense. `dtype=None` computes in the input's dtype;
    `init_std` replaces the lecun-normal init with a plain normal.

    A call that computes in float32 on a CUDA input, wants no autograd
    graph, and has in and out features that are multiples of 4 runs kernel
    L (`ops/linear_kernel.py`: 3xTF32 on the tensor cores, float32
    accuracy), with the weight's split planes kept beside it and split
    again when the weight changes; every other call runs `F.linear`."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: Optional[torch.dtype] = None,
                 init_std: Optional[float] = None):
        self.compute_dtype = dtype
        self.init_std = init_std
        super().__init__(in_features, out_features, bias=bias)

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            if self.init_std is None:
                _lecun_normal_(self.weight, generator)
            else:
                nn.init.normal_(self.weight, 0.0, self.init_std,
                                generator=generator)
            if self.bias is not None:
                self.bias.zero_()

    def wants_graph(self, *inputs: Optional[torch.Tensor]) -> bool:
        """Whether a call on `inputs` builds an autograd graph."""
        return torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (*inputs, self.weight, self.bias))

    def weight_planes(self) -> torch.Tensor:
        """Kernel L's split planes of the weight, split again when its
        version counter or its storage changes."""
        w = self.weight
        # an inference tensor keeps no version counter: split every call
        key = None if w.is_inference() else (w._version, w.data_ptr(),
                                             w.device)
        kept = getattr(self, "_planes", None)
        if key is None or kept is None or kept[0] != key:
            kept = (key, weight_planes(w))
            self._planes = kept
        return kept[1]

    def forward(self, x: Union[torch.Tensor, Tuple[torch.Tensor, ...]],
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: a tensor, or a tuple of the consecutive parts of its last
        dimension (read in place where kernel L takes the call); residual:
        added to the output, in its dtype."""
        parts = x if isinstance(x, tuple) else (x,)
        dt = self.compute_dtype or parts[0].dtype
        parts = tuple(p.to(dt) for p in parts)
        if linear_route(self.in_features, self.out_features, dt,
                        parts[0].device.type,
                        self.wants_graph(*parts, residual)) \
                and (residual is None or residual.dtype == dt):
            if len(parts) > 1 and parts[0].shape[-1] % 32:
                parts = (torch.cat(parts, -1),)
            return linear_tf32(parts, self.weight, self.bias, residual,
                               planes=self.weight_planes())
        x = torch.cat(parts, -1) if len(parts) > 1 else parts[0]
        bias = None if self.bias is None else self.bias.to(dt)
        y = F.linear(x, self.weight.to(dt), bias)
        return y if residual is None else residual + y.to(residual.dtype)


class Conv2d(nn.Conv2d):
    """flax nn.Conv, stride 1, with flax's `padding`: "SAME" pads an odd
    kernel by kernel // 2 on each side (none for 1x1), "VALID" pads
    nothing."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int,
                 dtype: torch.dtype = torch.float32, padding: str = "SAME"):
        if padding not in ("SAME", "VALID"):
            raise ValueError(f"padding {padding!r}: SAME or VALID")
        self.compute_dtype = dtype
        super().__init__(in_channels, out_channels, kernel,
                         padding=kernel // 2 if padding == "SAME" else 0)

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            _lecun_normal_(self.weight, generator)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.conv2d(x.to(dt), self.weight.to(dt), self.bias.to(dt),
                        padding=self.padding)


class BatchNorm(nn.Module):
    """flax nn.BatchNorm(momentum=0.9, epsilon=1e-5) over the channel axis
    of an NCHW tensor.

    In eval() it normalises with the running statistics. In train() it
    normalises with the batch's, as flax does with
    use_running_average=False: the mean and the BIASED variance over
    (N, H, W), reduced in at least float32 in flax's fast form E[x^2] -
    E[x]^2 clipped at 0, the output cast back to the input's dtype; and it
    updates the running statistics as r <- 0.9 r + 0.1 batch, the biased
    variance too. (torch's F.batch_norm(training=True) would update the
    running variance with the unbiased one, n / (n - 1) larger, and so
    would torch.nn.SyncBatchNorm.)

    Under a mesh with a data group (`parallel.mesh.use_mesh`) the batch is
    the global one, as under the JAX package's data-parallel mesh: the
    per-channel sums of x and x^2 and the element count are all-reduced
    in float32 (`all_reduce_sum`: the gradient reaches every rank's rows)
    before the mean and E[x^2], so the running statistics stay equal on
    every rank."""

    MOMENTUM = 0.9   # the JAX package's (models/vgg.py)

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        group = data_group()
        if group is None:
            mean = xf.mean(dim=(0, 2, 3))
            mean2 = (xf * xf).mean(dim=(0, 2, 3))
        else:
            C = xf.shape[1]
            count = xf.new_full((1,), xf.numel() // C)
            sums = all_reduce_sum(torch.cat([
                xf.sum(dim=(0, 2, 3)), (xf * xf).sum(dim=(0, 2, 3)), count]),
                group)
            mean, mean2 = sums[:C] / sums[-1], sums[C:2 * C] / sums[-1]
        var = (mean2 - mean * mean).clamp(min=0.0)
        with torch.no_grad():
            self.running_mean.mul_(self.MOMENTUM).add_(
                mean.detach() * (1.0 - self.MOMENTUM))
            self.running_var.mul_(self.MOMENTUM).add_(
                var.detach() * (1.0 - self.MOMENTUM))
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None] \
            + self.bias[:, None, None]
        return y.to(x.dtype)


class LayerNorm(nn.LayerNorm):
    """flax nn.LayerNorm: epsilon 1e-6 (torch's default is 1e-5), float32
    statistics, output in the compute dtype."""

    def __init__(self, features: int, dtype: Optional[torch.dtype] = None,
                 eps: float = 1e-6):
        self.compute_dtype = dtype
        super().__init__(features, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight,
                         self.bias, self.eps)
        return y.to(self.compute_dtype or x.dtype)


def init_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """Re-initialise every Linear and Conv2d of `model` from `generator`
    (a CPU generator: call before moving the model to the card)."""
    for m in model.modules():
        if isinstance(m, (Linear, Conv2d)):
            m.reset_parameters(generator)
