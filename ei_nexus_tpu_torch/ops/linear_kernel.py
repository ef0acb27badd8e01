"""Kernel L: LightGlue's float32 linear layers, y = x W^T + b, on the
tensor cores in 3xTF32 (`csrc/linear_tf32.cu`).

No TPU kernel precedes it: the JAX package leaves nn.Dense to XLA's dot.
On the card a float32 `F.linear` with TF32 off is cuBLAS's SGEMM on the
CUDA cores; the float32 eval forwards take their linear products to the
tensor cores at float32 accuracy instead, as the float32 attention loops
do (`attention_kernels.py`):

 - `linear_tf32(x, weight, bias=None, residual=None, planes=None)`: x a
   float32 (..., K) tensor, or a tuple of tensors read as consecutive parts
   of K (the FFN's [x, message], read in place of their concatenation);
   residual (..., N), added last; planes: `weight_planes(weight)`, split
   anew where not given;
 - `linear_tf32_plain`: its plain PyTorch version, which defines the
   arithmetic: x and W split into TF32 hi and lo (`tf32_split_plain`), y =
   x_lo W_hi^T + x_hi W_lo^T + x_hi W_hi^T in float32 (~2^-21 relative per
   product), then fl(y + b), then fl(residual + that);
 - `weight_planes(weight)`: W's (2, N, Kp) hi/lo planes, Kp = K rounded up
   to 32, each 16-column group in `linear_k_order` (the order the kernel's
   register fragments read x's columns), zeros past K. The kernel reads W
   only through them; `models/layers.py:Linear` keeps them beside its
   weight and splits them again when the weight changes.

`models/layers.py:Linear.forward` routes a call here (`linear_route`) when
it computes in float32 on a CUDA input, no autograd graph is wanted, and
its in and out features are multiples of 4 (TMA's 16-byte strides); every
other call keeps `F.linear`. On a CPU tensor `linear_tf32` runs the plain
version; on a CUDA tensor it launches the kernel or raises.
`linear_tf32.launches` counts its launches, `linear_tf32.plane_builds` the
splits of W's planes on the card (plain PyTorch operations, once a weight).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch

from .attention_kernels import _on_device, tf32_split_plain
from .cuda_build import check, library

_CHUNK = 32     # the kernel's K chunk: W's planes are padded to it

Parts = Union[torch.Tensor, Tuple[torch.Tensor, ...]]


def linear_k_order(kp: int, device=None) -> torch.Tensor:
    """The column of W at each of the `kp` (a multiple of 16) positions of
    its planes: position 16p + 8q + 4h + j of a 16-column group holds column
    16p + 4j + 2q + h, so that the kernel's lane t, loading columns 4t ..
    4t + 3 of the group, takes 4t + 2q and 4t + 2q + 1 as A columns t and
    t + 4 of the group's k8 slice q."""
    p = torch.arange(kp, device=device)
    return (p & ~15) | (4 * (p & 3) + 2 * ((p >> 3) & 1) + ((p >> 2) & 1))


def weight_planes(weight: torch.Tensor) -> torch.Tensor:
    """(2, N, Kp) float32 hi/lo planes of the (N, K) weight, contiguous:
    Kp = K rounded up to 32, columns in `linear_k_order`, zeros past K."""
    N, K = weight.shape
    kp = -(-K // _CHUNK) * _CHUNK
    with torch.no_grad():
        w = weight.new_zeros(N, kp, dtype=torch.float32)
        w[:, :K] = weight
        planes = torch.stack(tf32_split_plain(
            w[:, linear_k_order(kp, weight.device)])).contiguous()
    if weight.is_cuda:
        linear_tf32.plane_builds += 1
    return planes


def _parts(x: Parts) -> Tuple[torch.Tensor, ...]:
    return x if isinstance(x, tuple) else (x,)


def linear_tf32_plain(x: Parts, weight: torch.Tensor,
                      bias: Optional[torch.Tensor] = None,
                      residual: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Plain PyTorch version of kernel L (float32)."""
    parts = _parts(x)
    x = torch.cat(parts, -1) if len(parts) > 1 else parts[0]
    xh, xl = tf32_split_plain(x)
    wh, wl = tf32_split_plain(weight)
    y = torch.matmul(xl, wh.T) + torch.matmul(xh, wl.T)
    y = y + torch.matmul(xh, wh.T)
    if bias is not None:
        y = y + bias.float()
    if residual is not None:
        y = residual.float() + y
    return y


def _tma_ready(t: torch.Tensor) -> torch.Tensor:
    """`t` as a (rows, K) matrix the kernel's TMA maps read in place: unit
    column stride, row stride and address on 16 bytes; copied otherwise."""
    m = t.reshape(-1, t.shape[-1])
    if m.stride(1) != 1 or m.stride(0) % 4 or m.data_ptr() % 16:
        m = m.contiguous()
    return m


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """`t` contiguous on 8 bytes (the kernel's float2 loads of the bias and
    the residual)."""
    t = t.contiguous()
    return t if t.data_ptr() % 8 == 0 else t.clone()


def _check(name: str, tensors: Sequence[torch.Tensor], device) -> None:
    for t in tensors:
        if t.device != device or t.dtype != torch.float32:
            raise ValueError(f"{name}: operands must be float32 on "
                             f"{device}, got {t.dtype} on {t.device}")
        if t.requires_grad and torch.is_grad_enabled():
            raise NotImplementedError(f"{name} has no backward")


def linear_tf32(x: Parts, weight: torch.Tensor,
                bias: Optional[torch.Tensor] = None,
                residual: Optional[torch.Tensor] = None,
                planes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x W^T + b (+ residual) in float32 through 3xTF32 products: x (...,
    K) float32, or a tuple of parts of K (the first part's K a multiple of
    32 on the card); weight (N, K); bias (N,); residual (..., N); planes
    `weight_planes(weight)`. CPU tensors: the plain version. CUDA tensors
    (K and N multiples of 4): kernel L, or an exception."""
    parts = _parts(x)
    if parts[0].device.type == "cpu":
        return linear_tf32_plain(parts, weight, bias, residual)
    name = "linear_tf32"
    if parts[0].device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {parts[0].device}")
    device = parts[0].device
    N, K = weight.shape
    ks = [p.shape[-1] for p in parts]
    lead = parts[0].shape[:-1]
    if len(parts) > 2 or sum(ks) != K \
            or any(p.shape[:-1] != lead for p in parts):
        raise ValueError(f"{name}: x parts {[tuple(p.shape) for p in parts]}"
                         f" do not make (..., {K})")
    if K % 4 or N % 4:
        raise ValueError(f"{name}: K={K} and N={N} must be multiples of 4")
    if len(parts) == 2 and ks[0] % _CHUNK:
        raise ValueError(f"{name}: the first part's K={ks[0]} must be a "
                         f"multiple of {_CHUNK}")
    extra = [t for t in (bias, residual) if t is not None]
    _check(name, list(parts) + [weight] + extra, device)
    if bias is not None and tuple(bias.shape) != (N,):
        raise ValueError(f"{name}: bias {tuple(bias.shape)} is not ({N},)")
    if residual is not None and tuple(residual.shape) != (*lead, N):
        raise ValueError(f"{name}: residual {tuple(residual.shape)} is not "
                         f"{(*lead, N)}")
    if planes is None:
        planes = weight_planes(weight)
    kp = -(-K // _CHUNK) * _CHUNK
    if tuple(planes.shape) != (2, N, kp) or not planes.is_contiguous() \
            or planes.device != device:
        raise ValueError(f"{name}: planes {tuple(planes.shape)} are not "
                         f"weight_planes' (2, {N}, {kp})")
    xs = [_tma_ready(p) for p in parts]
    M = xs[0].shape[0]
    out = torch.empty(M, N, dtype=torch.float32, device=device)
    if M == 0:
        return out.view(*lead, N)
    bias = None if bias is None else _aligned(bias)
    res = None if residual is None else _aligned(residual.reshape(M, N))
    x1 = xs[1] if len(xs) == 2 else None
    with _on_device(device):
        err = library(name).ei_linear_tf32(
            xs[0].data_ptr(), xs[0].stride(0), ks[0],
            None if x1 is None else x1.data_ptr(),
            0 if x1 is None else x1.stride(0), 0 if x1 is None else ks[1],
            planes.data_ptr(), None if bias is None else bias.data_ptr(),
            None if res is None else res.data_ptr(), N, out.data_ptr(), N,
            M, N, torch.cuda.current_stream().cuda_stream)
    check(err, name)
    linear_tf32.launches += 1
    return out.view(*lead, N)


def linear_route(in_features: int, out_features: int, dtype: torch.dtype,
                 device_type: str, graph: bool) -> bool:
    """Whether a linear layer's call takes kernel L: it computes in float32
    on a CUDA input, wants no autograd graph, and its in and out features
    are multiples of 4."""
    return (dtype == torch.float32 and device_type == "cuda" and not graph
            and in_features % 4 == 0 and out_features % 4 == 0)


linear_tf32.launches = 0
linear_tf32.plane_builds = 0
