"""Kernels A, B, D, E and F: LightGlue's fused attention.

Counterpart of `ei_nexus_tpu/ops/pallas_attention.py`:

 - `self_attention(q, k, v, kv_mask, rot=(cos, sin), block_q=0)`: kernel
   A, row-softmax self-attention with the rotary encoding fused in (TPU
   kernel `_whole_rot_kernel`); without rot, kernel D's forward (TPU
   `_generic_fwd_kernel`); with block_q > 0 dividing N, kernel E;
 - `cross_attention_bidir(qk0, qk1, v0, v1, mask0, mask1, block_q=0)`:
   kernel B, shared-QK bidirectional cross-attention (TPU kernel
   `_cross_kernel`); with block_q > 0 dividing N and M, two launches of
   kernel E, one a direction, at scale 1;
 - `qblock_attention(q, k, v, bias, scale, block_q, rot=None)`: kernel E,
   q-blocked attention with or without the fused rotary (TPU kernels
   `_qblock_kernel` and `_qblock_rot_kernel`), block_q 64 or 128;
 - `fused_attention(q, k, v, kv_mask, scale)`: the differentiable attention
   of the training path (TPU `fused_attention_vjp`), a
   `torch.autograd.Function` whose forward is kernel D (`attention_fwd`,
   TPU `_generic_fwd_kernel`) and whose backward is kernel F
   (`attention_bwd`, TPU `_attention_bwd_kernel`).

On a CUDA tensor each launches its hand-written kernel (csrc/) or raises;
on a CPU tensor each runs its plain PyTorch version (`*_plain`), which
defines the semantics: masks are KEY-side only, as additive float32 biases
(0 / -1e9); the similarity is the float32 product of the operands, scaled
after the product (self: d^-0.5; cross: 1, its inputs come pre-scaled);
the row softmax is float32 and its probabilities enter the PV product in
the value dtype; the rotary encoding t*cos + rotate_half(t)*sin runs in the
operand dtype. Kernel E computes the same function as A and D (its blocks
own block_q query rows instead of 128), so the plain versions are shared.

The kernels read q/k/v through strides (no copy of the strided views the
LightGlue blocks produce) and write their outputs as (B, h, N, d) views of
(B, N, h, d) buffers, so the caller's merge of the heads is free.

The backward's plain version reproduces the TPU kernel's rounding points:
dO in the operand dtype, dS = P o (dP - c) and P^T rounded to it before
their products, c = rowsum(dP o P), P^T from the forward's row statistics.
Kernel F takes c = rowsum(dO o O) instead (equal up to the rounding of O)
and P = exp(S - lse) from the log-sum-exp kernel D saves; the mask gets no
gradient.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .cuda_build import check, dtype_code, int64_array, library

_BIAS = -1e9
_HEAD_DIM = 64  # the head dim the kernels are compiled for


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    """LightGlue's interleaved rotary pairing: out[2m] = -x[2m+1],
    out[2m+1] = x[2m]."""
    y = x.unflatten(-1, (-1, 2))
    return torch.stack([-y[..., 1], y[..., 0]], dim=-1).flatten(-2)


def key_bias(mask: Optional[torch.Tensor], batch: int, n: int,
             device) -> torch.Tensor:
    """(B, N) bool key mask -> contiguous (B, N) float32 additive bias."""
    if mask is None:
        return torch.zeros(batch, n, dtype=torch.float32, device=device)
    return torch.where(mask, 0.0, _BIAS).to(torch.float32).contiguous()


def _row_attention(q, k, v, bias, scale: float) -> torch.Tensor:
    s = torch.matmul(q.float(), k.float().mT) * scale + bias[:, None, None]
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)


def _rotate(t: torch.Tensor, rot) -> torch.Tensor:
    """The rotary encoding of (B, h, N, d) `t` with head-shared (B, N, d)
    (cos, sin) tables, in t's dtype."""
    cos, sin = rot[0][:, None], rot[1][:, None]
    return t * cos + rotate_half(t) * sin


def self_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         kv_mask: Optional[torch.Tensor] = None,
                         rot: Optional[Tuple[torch.Tensor, torch.Tensor]]
                         = None) -> torch.Tensor:
    """Plain PyTorch version of kernel A on (B, h, N, d) operands; rot =
    (cos, sin) head-shared (B, N, d) tables."""
    B, _, N, d = q.shape
    return qblock_attention_plain(q, k, v, key_bias(kv_mask, B, N, q.device),
                                  d ** -0.5, rot)


def qblock_attention_plain(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, bias: torch.Tensor, scale: float,
                           rot: Optional[Tuple[torch.Tensor, torch.Tensor]]
                           = None) -> torch.Tensor:
    """Plain PyTorch version of kernel E (the arithmetic of A and D): q
    (B, h, N, d) over k, v (B, h, M, d) with the (B, M) float32 key bias;
    rot = (cos, sin) (B, N, d) tables rotate q and k (then N == M)."""
    if rot is not None:
        q, k = _rotate(q, rot), _rotate(k, rot)
    return _row_attention(q, k, v, bias, scale)


def cross_attention_bidir_plain(qk0: torch.Tensor, qk1: torch.Tensor,
                                v0: torch.Tensor, v1: torch.Tensor,
                                mask0: Optional[torch.Tensor] = None,
                                mask1: Optional[torch.Tensor] = None
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel B: (m0 (B, h, N, d), m1 (B, h, M, d))."""
    B, _, N, _ = qk0.shape
    M = qk1.shape[2]
    bias0 = key_bias(mask0, B, N, qk0.device)
    bias1 = key_bias(mask1, B, M, qk0.device)
    return (_row_attention(qk0, qk1, v1, bias1, 1.0),
            _row_attention(qk1, qk0, v0, bias0, 1.0))


def fused_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          kv_mask: Optional[torch.Tensor] = None,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version of kernel D: q (B, h, N, d), k and v
    (B, h, M, d), kv_mask (B, M) masks keys; scale defaults to d^-0.5."""
    B, _, _, d = q.shape
    scale = d ** -0.5 if scale is None else scale
    return _row_attention(q, k, v, key_bias(kv_mask, B, k.shape[2], q.device),
                          scale)


def fused_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, bias: torch.Tensor,
                              do: torch.Tensor, scale: float
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Plain PyTorch version of kernel F: (dq, dk, dv) of kernel D for the
    output gradient `do` (cast to q's dtype) and the (B, M) float32 key
    bias, rounded where the TPU kernel rounds."""
    do = do.to(q.dtype)
    s = torch.matmul(q.float(), k.float().mT) * scale + bias[:, None, None]
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    p = e / e.sum(dim=-1, keepdim=True)
    dp = torch.matmul(do.float(), v.float().mT)
    c = (dp * p).sum(dim=-1, keepdim=True)
    ds = (p * (dp - c)).to(q.dtype).float()
    dq = (torch.matmul(ds, k.float()) * scale).to(q.dtype)
    dv = torch.matmul(p.to(do.dtype).float().mT, do.float()).to(v.dtype)
    dk = (torch.matmul(ds.mT, q.float()) * scale).to(k.dtype)
    return dq, dk, dv


def _check_cuda(name: str, *tensors: torch.Tensor,
                differentiable: bool = False) -> int:
    """Common checks of the kernel wrappers; returns the dtype code. Only
    the autograd pieces (D, F) may see tensors that require grad."""
    dev, dt = tensors[0].device, tensors[0].dtype
    for t in tensors:
        if t.device != dev or t.dtype != dt:
            raise ValueError(f"{name}: operands differ in device or dtype")
        if t.ndim != 4 or t.shape[-1] != _HEAD_DIM:
            raise ValueError(f"{name}: expected (B, h, N, {_HEAD_DIM}) "
                             f"operands, got {tuple(t.shape)}")
        if not differentiable and t.requires_grad and torch.is_grad_enabled():
            raise NotImplementedError(f"{name} has no backward")
    return dtype_code(dt)


def _check_rows(name: str, t: torch.Tensor, shape) -> torch.Tensor:
    """A float32 per-row tensor of the kernels (bias, lse), contiguous."""
    if tuple(t.shape) != tuple(shape) or t.dtype != torch.float32:
        raise ValueError(f"{name}: expected a float32 {tuple(shape)} tensor, "
                         f"got {t.dtype} {tuple(t.shape)}")
    return t.contiguous()


def _heads_out(B: int, h: int, n: int, d: int, like: torch.Tensor):
    """(B, h, n, d) view of a fresh (B, n, h, d) buffer."""
    return torch.empty(B, n, h, d, dtype=like.dtype,
                       device=like.device).permute(0, 2, 1, 3)


def _rot_tables(name: str, rot, q: torch.Tensor):
    """(cos, sin) contiguous, checked to be (B, N, d) in q's dtype and
    device."""
    B, _, N, d = q.shape
    cos, sin = (t.contiguous() for t in rot)
    for t in (cos, sin):
        if t.shape != (B, N, d) or t.dtype != q.dtype \
                or t.device != q.device:
            raise ValueError(f"{name}: rot tables must be (B, N, d) in the "
                             f"operands' dtype and device")
    return cos, sin


def self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   kv_mask: Optional[torch.Tensor] = None,
                   rot: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                   block_q: int = 0) -> torch.Tensor:
    """(B, h, N, d) self-attention, kv_mask (B, N) masks keys, rot =
    (cos, sin) (B, N, d) tables fused into q and k.

    CPU tensors: the plain version. CUDA tensors (d must be 64): kernel E
    when block_q > 0 divides N (as the TPU's `self_attention` picks its
    q-blocked kernels), else kernel A with rot and kernel D's forward
    without; or an exception."""
    if q.device.type == "cpu":
        return self_attention_plain(q, k, v, kv_mask, rot)
    if q.device.type != "cuda":
        raise ValueError(f"self_attention: unsupported device {q.device}")
    B, h, N, d = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("self_attention: q, k, v must have one shape")
    bias = key_bias(kv_mask, B, N, q.device)
    if block_q and N % block_q == 0:
        return qblock_attention(q, k, v, bias, d ** -0.5, block_q, rot)
    if rot is None:
        return attention_fwd(q, k, v, bias, d ** -0.5)[0]
    code = _check_cuda("self_attention", q, k, v)
    cos, sin = _rot_tables("self_attention", rot, q)
    if bias.shape != (B, N):
        raise ValueError("self_attention: kv_mask must be (B, N)")
    out = _heads_out(B, h, N, d, q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = library("self_attention").ei_self_attention_rot(
            code, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            int64_array(q.stride() + k.stride() + v.stride()),
            cos.data_ptr(), sin.data_ptr(), bias.data_ptr(), out.data_ptr(),
            int64_array(out.stride()), B, h, N, d ** -0.5, stream)
    check(err, "self_attention")
    self_attention.launches += 1
    return out


def qblock_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: torch.Tensor, scale: float, block_q: int,
                     rot: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                     ) -> torch.Tensor:
    """Kernel E: q (B, h, N, d) over k, v (B, h, M, d) with the (B, M)
    float32 key bias and softmax scale, blocks of block_q query rows; rot =
    (cos, sin) (B, N, d) tables fused into q and k (then N == M).

    CPU tensors: the plain version. CUDA tensors: the CUDA kernel, or an
    exception (d must be 64; block_q 64 or 128, the compiled tiles)."""
    if q.device.type == "cpu":
        return qblock_attention_plain(q, k, v, bias, scale, rot)
    if q.device.type != "cuda":
        raise ValueError(f"qblock_attention: unsupported device {q.device}")
    if block_q not in (64, 128):
        raise ValueError(f"qblock_attention: block_q={block_q}; the kernel "
                         f"is compiled for 64 and 128")
    code = _check_cuda("qblock_attention", q, k, v)
    B, h, N, d = q.shape
    M = k.shape[2]
    if k.shape[:2] != (B, h) or v.shape != k.shape:
        raise ValueError("qblock_attention: mismatched shapes")
    bias = _check_rows("qblock_attention bias", bias, (B, M))
    cos = sin = None
    if rot is not None:
        if M != N:
            raise ValueError("qblock_attention: rot needs N == M")
        cos, sin = _rot_tables("qblock_attention", rot, q)
    out = _heads_out(B, h, N, d, q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = library("qblock_attention").ei_qblock_attention(
            code, block_q, int(rot is not None), q.data_ptr(), k.data_ptr(),
            v.data_ptr(), int64_array(q.stride() + k.stride() + v.stride()),
            None if cos is None else cos.data_ptr(),
            None if sin is None else sin.data_ptr(), bias.data_ptr(),
            out.data_ptr(), int64_array(out.stride()), B, h, N, M,
            float(scale), stream)
    check(err, "qblock_attention")
    qblock_attention.launches += 1
    return out


def cross_attention_bidir(qk0: torch.Tensor, qk1: torch.Tensor,
                          v0: torch.Tensor, v1: torch.Tensor,
                          mask0: Optional[torch.Tensor] = None,
                          mask1: Optional[torch.Tensor] = None,
                          block_q: int = 0
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel B: shared-QK bidirectional cross attention. qk0 (B, h, N, d)
    and qk1 (B, h, M, d) are pre-scaled by d^-0.25; returns
    (m0 (B, h, N, d), m1 (B, h, M, d)) with key-side masks only.

    CPU tensors: the plain version. CUDA tensors (d must be 64): two
    launches of kernel E at scale 1, (qk0 -> qk1, v1) and (qk1 -> qk0, v0),
    when block_q > 0 divides N and M (the TPU's q-blocked cross path),
    else kernel B (one launch for both directions); or an exception."""
    if qk0.device.type == "cpu":
        return cross_attention_bidir_plain(qk0, qk1, v0, v1, mask0, mask1)
    if qk0.device.type != "cuda":
        raise ValueError(
            f"cross_attention_bidir: unsupported device {qk0.device}")
    code = _check_cuda("cross_attention_bidir", qk0, qk1, v0, v1)
    B, h, N, d = qk0.shape
    M = qk1.shape[2]
    if v0.shape != qk0.shape or v1.shape != qk1.shape \
            or qk1.shape[:2] != (B, h):
        raise ValueError("cross_attention_bidir: mismatched shapes")
    bias0 = key_bias(mask0, B, N, qk0.device)
    bias1 = key_bias(mask1, B, M, qk0.device)
    if bias0.shape != (B, N) or bias1.shape != (B, M):
        raise ValueError("cross_attention_bidir: masks must be (B, N), "
                         "(B, M)")
    if block_q and N % block_q == 0 and M % block_q == 0:
        return (qblock_attention(qk0, qk1, v1, bias1, 1.0, block_q),
                qblock_attention(qk1, qk0, v0, bias0, 1.0, block_q))
    out0 = _heads_out(B, h, N, d, qk0)
    out1 = _heads_out(B, h, M, d, qk0)
    with torch.cuda.device(qk0.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = library("cross_attention").ei_cross_attention_bidir(
            code, qk0.data_ptr(), qk1.data_ptr(), v0.data_ptr(),
            v1.data_ptr(),
            int64_array(qk0.stride() + qk1.stride() + v0.stride()
                        + v1.stride()),
            bias0.data_ptr(), bias1.data_ptr(), out0.data_ptr(),
            out1.data_ptr(), int64_array(out0.stride() + out1.stride()),
            B, h, N, M, stream)
    check(err, "cross_attention_bidir")
    cross_attention_bidir.launches += 1
    return out0, out1


def attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  bias: torch.Tensor, scale: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel D: (out (B, h, N, d), lse (B, h, N) float32) of row-softmax
    attention of q (B, h, N, d) over k, v (B, h, M, d) with the (B, M)
    float32 key bias; lse is each row's log-sum-exp of the scaled, biased
    scores, which kernel F reads.

    CPU tensors: the plain version. CUDA tensors: the CUDA kernel, or an
    exception (d must be 64)."""
    if q.device.type == "cpu":
        s = torch.matmul(q.float(), k.float().mT) * scale \
            + bias[:, None, None]
        return (_row_attention(q, k, v, bias, scale),
                torch.logsumexp(s, dim=-1))
    if q.device.type != "cuda":
        raise ValueError(f"attention_fwd: unsupported device {q.device}")
    code = _check_cuda("attention_fwd", q, k, v, differentiable=True)
    B, h, N, d = q.shape
    M = k.shape[2]
    if k.shape[:2] != (B, h) or v.shape != k.shape:
        raise ValueError("attention_fwd: mismatched shapes")
    bias = _check_rows("attention_fwd bias", bias, (B, M))
    out = _heads_out(B, h, N, d, q)
    lse = torch.empty(B, h, N, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = library("attention_fwd").ei_attention_fwd(
            code, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            int64_array(q.stride() + k.stride() + v.stride()),
            bias.data_ptr(), out.data_ptr(), int64_array(out.stride()),
            lse.data_ptr(), B, h, N, M, float(scale), stream)
    check(err, "attention_fwd")
    attention_fwd.launches += 1
    return out, lse


def attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  out: torch.Tensor, do: torch.Tensor, bias: torch.Tensor,
                  lse: torch.Tensor, scale: float
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel F: (dq, dk, dv) of kernel D, given its output `out` and
    log-sum-exp `lse` and the output gradient `do` (cast to q's dtype).

    CPU tensors: the plain version (which recomputes the row statistics
    and c = rowsum(dP o P) as the TPU kernel does). CUDA tensors: the CUDA
    kernel, or an exception."""
    do = do.to(q.dtype)
    if q.device.type == "cpu":
        return fused_attention_bwd_plain(q, k, v, bias, do, scale)
    if q.device.type != "cuda":
        raise ValueError(f"attention_bwd: unsupported device {q.device}")
    code = _check_cuda("attention_bwd", q, k, v, out, do,
                       differentiable=True)
    B, h, N, d = q.shape
    M = k.shape[2]
    if k.shape[:2] != (B, h) or v.shape != k.shape or out.shape != q.shape \
            or do.shape != q.shape:
        raise ValueError("attention_bwd: mismatched shapes")
    bias = _check_rows("attention_bwd bias", bias, (B, M))
    lse = _check_rows("attention_bwd lse", lse, (B, h, N))
    dq = _heads_out(B, h, N, d, q)
    dk = _heads_out(B, h, M, d, q)
    dv = _heads_out(B, h, M, d, q)
    c = torch.empty(B, h, N, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = library("attention_bwd").ei_attention_bwd(
            code, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            do.data_ptr(),
            int64_array(q.stride() + k.stride() + v.stride() + out.stride()
                        + do.stride()),
            bias.data_ptr(), lse.data_ptr(), c.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(),
            int64_array(dq.stride() + dk.stride() + dv.stride()),
            B, h, N, M, float(scale), stream)
    check(err, "attention_bwd")
    attention_bwd.launches += 1
    return dq, dk, dv


class _FusedAttention(torch.autograd.Function):
    """Forward: kernel D (saving q, k, v, the bias, the output and the
    log-sum-exp); backward: kernel F. The bias gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale):
        out, lse = attention_fwd(q, k, v, bias, scale)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, out, lse = ctx.saved_tensors
        dq, dk, dv = attention_bwd(q, k, v, out, do, bias, lse, ctx.scale)
        return dq, dk, dv, None, None


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_mask: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Differentiable fused attention (the training path): q (B, h, N, d)
    over k, v (B, h, M, d), kv_mask (B, M) masks keys (no gradient); scale
    defaults to d^-0.5 (1.0 for LightGlue's pre-scaled cross projections).
    Kernel D forward, kernel F backward on CUDA tensors; their plain
    versions on CPU tensors."""
    B, _, _, d = q.shape
    scale = d ** -0.5 if scale is None else float(scale)
    bias = key_bias(kv_mask, B, k.shape[2], q.device)
    return _FusedAttention.apply(q, k, v, bias, scale)


self_attention.launches = 0
cross_attention_bidir.launches = 0
qblock_attention.launches = 0
attention_fwd.launches = 0
attention_bwd.launches = 0
