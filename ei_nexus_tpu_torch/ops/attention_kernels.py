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
(B, N, h, d) buffers, so the caller's merge of the heads is free. The
float32 instances of A, B, D, E, F and G (`flash_kernel.flash_attention`)
run 3xTF32 products on the tensor cores after a pack pass (`pack_f32`,
plain version `pack_f32_plain`) that reads the operands through their
strides, rotates A's q and k (and E's where it takes the rotary), splits
each value x into TF32 hi = tf32(x) and lo = tf32(x - hi)
(`tf32_split_plain`) and writes the operands a product sums over tokens
with (V; F's q, k and dO) transposed, each 8-token group in the order the
loops' register fragments take (`vt_key_order`). The bfloat16 instances
of A, B, D, E, F and G (`hopper_attention`, `cross_attention_bidir`,
`attention_fwd`, `attention_bwd`, `flash_kernel.flash_attention`) read
their operands by TMA, which needs a unit d stride and 16-byte alignment:
`operand_plan` decides for each operand whether the loop reads it in
place or a pack pass first writes it (rotated where the rotary applies)
as contiguous scratch, and refuses what neither takes (`hopper_operands`
builds the kernels' operand array from the plans). In training one packing serves D and F: D hands the v it packed
(the self-attention's stride-3 view) to F through `_FusedAttention`, and F
reads it in place.

The backward's plain version reproduces the TPU kernel's rounding points:
dO in the operand dtype, dS = P o (dP - c) and P^T rounded to it before
their products, c = rowsum(dP o P), P^T from the forward's row statistics.
Kernel F computes the same c, in float32 from the P and dP it forms (a c
pass before its gradient loop), and reads no output of the forward, as the
TPU kernel takes (q, k, v, bias, dO): FlashAttention-2's rowsum(dO o O)
would read O rounded to the operand type, and where a row's value rows
nearly coincide, or its softmax is one-hot, dP - c cancels below that
rounding. F forms P = exp(s - m) / l from the row max m and row sum l
kernel D saves (`attention_fwd`'s `stats`), as the plain version forms
it: s - m before anything else, so a fully masked row (every s = -1e9)
gets P = 1/M. The mask gets no gradient.
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple, Optional, Tuple

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


def tf32_split_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) of float32 `x` as the float32 pack pass splits it: hi =
    tf32(x), lo = tf32(x - hi), where tf32 is cvt.rna.tf32.f32's rounding
    (to 10 fraction bits, to nearest with ties away from zero, the 13 low
    bits cleared), so x = hi + lo to 2^-22 |x|."""
    def tf32(t):
        bits = t.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)
    hi = tf32(x.float())
    return hi, tf32(x.float() - hi)


def vt_key_order(keys: int, device=None) -> torch.Tensor:
    """The key (token) at each position of a transposed plane of `keys` (a
    multiple of 8; V^T, and F's Q^T, K^T, dO^T): each 8-token group in the
    order 0, 2, 4, 6, 1, 3, 5, 7, so that column t of the TF32 A fragment
    of P (or dS; the loops fill it from accumulator columns 2t and 2t + 1)
    meets its token."""
    p = torch.arange(keys, device=device)
    return (p & ~7) | (2 * (p & 3) + ((p >> 2) & 1))


def _padded_keys(n: int) -> int:
    return -(-n // 64) * 64


def pack_f32_plain(rows, values, rot: Optional[Tuple[torch.Tensor,
                                                     torch.Tensor]] = None):
    """Plain version of the float32 pack pass of kernels A, B, D, E, F and G:
    (the (B, h, 2, n, 64) hi/lo planes of each (B, h, n, 64) operand of
    `rows`, rotated first by rot = (cos, sin) (B, n, 64) tables when given;
    the (B, h, 2, 64, keys) hi/lo planes of the transpose of each operand
    of `values` (V^T; F's Q^T, K^T, dO^T), keys = n rounded up to 64,
    positions in `vt_key_order`, zeros past n)."""
    planes = []
    for t in rows:
        t = t.float()
        if rot is not None:
            t = _rotate(t, (rot[0].float(), rot[1].float()))
        planes.append(torch.stack(tf32_split_plain(t), dim=2))
    vts = []
    for v in values:
        B, h, n, d = v.shape
        keys = _padded_keys(n)
        vp = torch.zeros(B, h, keys, d, dtype=torch.float32, device=v.device)
        vp[:, :, :n] = v
        vt = vp[:, :, vt_key_order(keys, v.device)].transpose(-1, -2)
        vts.append(torch.stack(tf32_split_plain(vt), dim=2))
    return planes, vts


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
                differentiable: bool = False) -> None:
    """Common checks of the kernel wrappers (a dtype other than float32 and
    bfloat16 raises TypeError). Only the autograd pieces (D, F) may see
    tensors that require grad."""
    dev, dt = tensors[0].device, tensors[0].dtype
    for t in tensors:
        if t.device != dev or t.dtype != dt:
            raise ValueError(f"{name}: operands differ in device or dtype")
        if t.ndim != 4 or t.shape[-1] != _HEAD_DIM:
            raise ValueError(f"{name}: expected (B, h, N, {_HEAD_DIM}) "
                             f"operands, got {tuple(t.shape)}")
        if not differentiable and t.requires_grad and torch.is_grad_enabled():
            raise NotImplementedError(f"{name} has no backward")
    dtype_code(dt)


def _check_rows(name: str, t: torch.Tensor, shape) -> torch.Tensor:
    """A float32 per-row tensor of the kernels (bias, stats), contiguous."""
    if tuple(t.shape) != tuple(shape) or t.dtype != torch.float32:
        raise ValueError(f"{name}: expected a float32 {tuple(shape)} tensor, "
                         f"got {t.dtype} {tuple(t.shape)}")
    return t.contiguous()


def _heads_out(B: int, h: int, n: int, d: int, like: torch.Tensor):
    """(B, h, n, d) view of a fresh (B, n, h, d) buffer."""
    return torch.empty(B, n, h, d, dtype=like.dtype,
                       device=like.device).permute(0, 2, 1, 3)


def _on_device(device: torch.device):
    """The device's context, or nothing where it is already current."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


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


class OperandPlan(NamedTuple):
    """How the Hopper loops (A, B, D, E, F, G) take one (B, h, rows, 64)
    operand."""
    mode: str        # "direct": TMA reads it in place; "pack": packed first
    ptr: int         # its data pointer (direct) or its 16-byte slab (pack)
    strides: Tuple[int, int, int]   # element strides (b, h, n) of its rows
    sd: int          # d stride: 1, or 3 in a (.., d, 3) Wqkv slab
    phase: int       # where d = 0 sits in the slab (elements, 0..2)


def operand_plan(t: torch.Tensor, rotate: bool = False) -> OperandPlan:
    """The Hopper loops' plan for operand `t` (B, h, rows, 64) of 2-byte
    elements, rotated by the rotary when `rotate`.

    Direct: unit d stride, 16-byte-aligned data and row strides, no
    rotary. Pack: d stride 1 or 3 (the (B, N, h, d, 3) split of a Wqkv
    output), its row's 64*sd-element slab starting 16-byte aligned and
    inside the tensor's storage; the pack pass reads the slab with 16-byte
    loads. Anything else raises ValueError."""
    if t.ndim != 4 or t.shape[-1] != _HEAD_DIM or t.element_size() != 2:
        raise ValueError(f"operand_plan: expected a (B, h, rows, "
                         f"{_HEAD_DIM}) operand of 2-byte elements, got "
                         f"{t.dtype} {tuple(t.shape)}")
    # a dimension of size 1 is never stepped: any aligned stride will do
    st, size = t.stride(), t.shape
    sb = st[0] if size[0] > 1 else 8
    sh = st[1] if size[1] > 1 else 8
    sn = st[2] if size[2] > 1 else 8
    sd = st[3]
    if min(sb, sh, sn, sd) < 1:
        raise ValueError(f"operand_plan: strides {t.stride()} overlap or "
                         f"run backwards")
    ptr = t.data_ptr()
    rows_aligned = sb % 8 == 0 and sh % 8 == 0 and sn % 8 == 0
    if not rotate and sd == 1 and ptr % 16 == 0 and rows_aligned:
        return OperandPlan("direct", ptr, (sb, sh, sn), 1, 0)
    phase = (ptr % 16) // 2
    if sd not in (1, 3) or phase >= sd or not rows_aligned:
        raise ValueError(
            f"operand_plan: strides {t.stride()} at byte offset {ptr % 16} "
            f"from 16: neither TMA (unit d stride, 16-byte rows) nor the "
            f"pack pass (d stride 1 or 3, 16-byte slabs) reads it")
    slab = ptr - 2 * phase
    storage = t.untyped_storage()
    last = (size[0] - 1) * sb + (size[1] - 1) * sh + (size[2] - 1) * sn
    if slab < storage.data_ptr() or slab + 2 * (last + _HEAD_DIM * sd) \
            > storage.data_ptr() + storage.nbytes():
        raise ValueError("operand_plan: the operand's 16-byte slabs reach "
                         "outside its storage")
    return OperandPlan("pack", slab, (sb, sh, sn), sd, phase)


def hopper_operands(tensors, rotate: int = 0):
    """(operand array, scratch, packed) of the Hopper loops for the
    (B, h, rows, 64) operands `tensors` (bit i of `rotate`: operand i takes
    the rotary): 8 integers an operand as `read_operand`
    (csrc/flash_sm90.cuh) reads them (pointer or slab, strides b, h, n, d
    stride, pack, phase, scratch pointer), from each one's `operand_plan`;
    one scratch buffer for the packed ones (None when none is packed: no
    pack launch); and for each operand its contiguous (B, h, rows, 64) view
    of the scratch, which the pack pass fills, or None where it is read in
    place. Raises ValueError before anything is allocated for an operand
    neither TMA nor the pack pass reads."""
    plans = [operand_plan(t, bool(rotate >> i & 1))
             for i, t in enumerate(tensors)]
    sizes = [t.numel() if p.mode == "pack" else 0
             for t, p in zip(tensors, plans)]
    scratch = torch.empty(sum(sizes), dtype=tensors[0].dtype,
                          device=tensors[0].device) if any(sizes) else None
    ops, packed, at = [], [], 0
    for t, plan, size in zip(tensors, plans, sizes):
        ops += [plan.ptr, *plan.strides, plan.sd, int(size > 0), plan.phase,
                scratch.data_ptr() + 2 * at if size else 0]
        packed.append(scratch[at:at + size].view(t.shape) if size else None)
        at += size
    return int64_array(ops), scratch, packed


def _pack_f32_launch(rows, values, rot=None, kernel: str = "self_attention"):
    """One launch of the float32 pack pass (counted in
    `hopper_attention.packs`) into one fresh buffer: (the buffer, and for
    each operand of rows, then values, (its planes' pointer, shape, offset
    in the buffer)). D's, E's, F's and G's wrappers pass the pointers on,
    so the host makes no view of a plane; they hold the buffer until their
    loop is launched."""
    B, h = rows[0].shape[:2]
    shapes = ([(B, h, 2, t.shape[2], _HEAD_DIM) for t in rows]
              + [(B, h, 2, _HEAD_DIM, _padded_keys(v.shape[2]))
                 for v in values])
    sizes = [math.prod(shape) for shape in shapes]
    buf = torch.empty(sum(sizes), dtype=torch.float32, device=rows[0].device)
    base, placed, jobs, at = buf.data_ptr(), [], [], 0
    for i, (t, shape, size) in enumerate(zip((*rows, *values), shapes,
                                             sizes)):
        is_value = i >= len(rows)
        jobs += [t.data_ptr(), *t.stride(), t.shape[2], int(is_value),
                 int(rot is not None and not is_value), base + 4 * at]
        placed.append((base + 4 * at, shape, at))
        at += size
    tables = (None, None) if rot is None else (rot[0].data_ptr(),
                                               rot[1].data_ptr())
    with _on_device(buf.device):
        err = library(kernel).ei_attention_pack_tf32(
            int64_array(jobs), len(jobs) // 9, *tables, B, h,
            torch.cuda.current_stream().cuda_stream)
    check(err, f"{kernel} pack")
    hopper_attention.packs += 1
    return buf, placed


def pack_f32(rows, values, rot: Optional[Tuple[torch.Tensor,
                                               torch.Tensor]] = None,
             kernel: str = "self_attention"):
    """The float32 pack pass of kernels A, B, D, E, F and G on the card, one
    launch of up to 8 operands (counted in `hopper_attention.packs`): what
    `pack_f32_plain` defines, from (B, h, n, 64) float32 operands of any
    strides; rot = (cos, sin) contiguous (B, n, 64) float32 tables, n the
    rows operands' count. `kernel` names the library that launches it."""
    buf, placed = _pack_f32_launch(rows, values, rot, kernel)
    planes = [buf[at:at + math.prod(shape)].view(shape)
              for _, shape, at in placed]
    return planes[:len(rows)], planes[len(rows):]


def hopper_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: torch.Tensor, scale: float, block_q: int,
                     rot: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                     kernel: str = "qblock_attention") -> torch.Tensor:
    """The bfloat16 Hopper loop of kernels A (`kernel="self_attention"`,
    block_q 128, rot required) and E (`"qblock_attention"`, block_q 64 or
    128): q (B, h, N, 64) over k, v (B, h, M, 64) on the card with the
    (B, M) float32 key bias (contiguous), the pack pass first where
    `operand_plan` asks for it. `hopper_attention.packs` counts the pack
    launches of every Hopper loop (A, B, D, E, F, G); the callers count
    their kernel's launches."""
    B, h, N, d = q.shape
    cos = sin = None
    if rot is not None:
        cos, sin = _rot_tables(kernel, rot, q)
        if cos.data_ptr() % 16 or sin.data_ptr() % 16:
            raise ValueError(f"{kernel}: rot tables must be 16-byte aligned")
    ops, scratch, _ = hopper_operands((q, k, v), 0 if rot is None else 3)
    out = _heads_out(B, h, N, d, q)
    ost = out.stride()[:3]
    tables = (None if cos is None else cos.data_ptr(),
              None if sin is None else sin.data_ptr())
    lib = library(kernel)
    with _on_device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if kernel == "self_attention":
            err = lib.ei_self_attention_sm90(
                ops, *tables, bias.data_ptr(), out.data_ptr(),
                int64_array(ost), B, h, N, float(scale), stream)
        else:
            err = lib.ei_qblock_attention_sm90(
                block_q, int(rot is not None), ops, *tables,
                bias.data_ptr(), out.data_ptr(), int64_array(ost), B, h, N,
                k.shape[2], float(scale), stream)
    check(err, kernel)
    hopper_attention.packs += scratch is not None
    return out


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
    _check_cuda("self_attention", q, k, v)
    if bias.shape != (B, N):
        raise ValueError("self_attention: kv_mask must be (B, N)")
    if q.dtype == torch.bfloat16:
        out = hopper_attention(q, k, v, bias, d ** -0.5, 128, rot,
                               kernel="self_attention")
        self_attention.launches += 1
        return out
    # float32: the pack pass, then the 3xTF32 loop
    (qp, kp), (vp,) = pack_f32((q, k), (v,), _rot_tables("self_attention",
                                                          rot, q))
    out = _heads_out(B, h, N, d, q)
    with _on_device(q.device):
        err = library("self_attention").ei_self_attention_tf32(
            qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), bias.data_ptr(),
            out.data_ptr(), int64_array(out.stride()[:3]), B, h, N,
            d ** -0.5, torch.cuda.current_stream().cuda_stream)
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

    CPU tensors: the plain version. CUDA tensors: the CUDA kernel
    (bfloat16: the Hopper loop, block_q rows a block, its operands as
    `operand_plan` takes them; float32: the pack pass's Q, K (rotated with
    rot) and V^T planes, then the 3xTF32 loop, 64 rows a block at either
    block_q, which the output does not depend on), or an exception (d must
    be 64; block_q 64 or 128, the compiled tiles)."""
    if q.device.type == "cpu":
        return qblock_attention_plain(q, k, v, bias, scale, rot)
    if q.device.type != "cuda":
        raise ValueError(f"qblock_attention: unsupported device {q.device}")
    if block_q not in (64, 128):
        raise ValueError(f"qblock_attention: block_q={block_q}; the kernel "
                         f"is compiled for 64 and 128")
    _check_cuda("qblock_attention", q, k, v)
    B, h, N, d = q.shape
    M = k.shape[2]
    if k.shape[:2] != (B, h) or v.shape != k.shape:
        raise ValueError("qblock_attention: mismatched shapes")
    bias = _check_rows("qblock_attention bias", bias, (B, M))
    if rot is not None and M != N:
        raise ValueError("qblock_attention: rot needs N == M")
    if q.dtype == torch.bfloat16:
        out = hopper_attention(q, k, v, bias, scale, block_q, rot)
        qblock_attention.launches += 1
        return out
    # float32: the pack pass, then the 3xTF32 loop
    if rot is not None:
        rot = _rot_tables("qblock_attention", rot, q)
    buf, ((qp, *_), (kp, *_), (vp, *_)) = _pack_f32_launch(
        (q, k), (v,), rot, kernel="qblock_attention")
    out = _heads_out(B, h, N, d, q)
    with _on_device(q.device):
        err = library("qblock_attention").ei_qblock_attention_tf32(
            qp, kp, vp, bias.data_ptr(), out.data_ptr(),
            int64_array(out.stride()[:3]), B, h, N, M, float(scale),
            torch.cuda.current_stream().cuda_stream)
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
    else kernel B (one launch for both directions; bfloat16 on the Hopper
    loop, its operands as `operand_plan` takes them; float32 on the 3xTF32
    loop after `pack_f32`); or an exception."""
    if qk0.device.type == "cpu":
        return cross_attention_bidir_plain(qk0, qk1, v0, v1, mask0, mask1)
    if qk0.device.type != "cuda":
        raise ValueError(
            f"cross_attention_bidir: unsupported device {qk0.device}")
    _check_cuda("cross_attention_bidir", qk0, qk1, v0, v1)
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
    scratch = None
    if qk0.dtype == torch.bfloat16:
        ops, scratch, _ = hopper_operands((qk0, qk1, v0, v1))
    else:
        # float32: the pack pass, then the 3xTF32 loop
        (p0, p1), (vt0, vt1) = pack_f32((qk0, qk1), (v0, v1),
                                        kernel="cross_attention")
    out0 = _heads_out(B, h, N, d, qk0)
    out1 = _heads_out(B, h, M, d, qk0)
    ost = int64_array(out0.stride()[:3] + out1.stride()[:3])
    lib = library("cross_attention")
    with _on_device(qk0.device):
        stream = torch.cuda.current_stream().cuda_stream
        if qk0.dtype == torch.bfloat16:
            err = lib.ei_cross_attention_sm90(
                ops, bias0.data_ptr(), bias1.data_ptr(), out0.data_ptr(),
                out1.data_ptr(), ost, B, h, N, M, stream)
        else:
            err = lib.ei_cross_attention_tf32(
                p0.data_ptr(), p1.data_ptr(), vt0.data_ptr(), vt1.data_ptr(),
                bias0.data_ptr(), bias1.data_ptr(), out0.data_ptr(),
                out1.data_ptr(), ost, B, h, N, M, stream)
    check(err, "cross_attention_bidir")
    hopper_attention.packs += scratch is not None
    cross_attention_bidir.launches += 1
    return out0, out1


def attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  bias: torch.Tensor, scale: float
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel D: (out (B, h, N, d), stats (2, B, h, N) float32, v_read) of
    row-softmax attention of q (B, h, N, d) over k, v (B, h, M, d) with the
    (B, M) float32 key bias; stats[0] is each row's max m of the scaled,
    biased scores s and stats[1] its sum l of exp(s - m), from which kernel
    F rebuilds P = exp(s - m) / l; v_read is the v the kernel read: the
    contiguous copy its pack pass wrote where it packed v (bfloat16 on the
    card; F then reads it in place), else v itself.

    CPU tensors: the plain version. CUDA tensors: the CUDA kernel
    (bfloat16: the Hopper loop, its operands as `operand_plan` takes them;
    float32: the pack pass's Q, K and V^T planes, then the 3xTF32 loop), or
    an exception (d must be 64)."""
    if q.device.type == "cpu":
        s = torch.matmul(q.float(), k.float().mT) * scale \
            + bias[:, None, None]
        m = s.amax(dim=-1)
        l = torch.exp(s - m[..., None]).sum(dim=-1)
        return _row_attention(q, k, v, bias, scale), torch.stack([m, l]), v
    if q.device.type != "cuda":
        raise ValueError(f"attention_fwd: unsupported device {q.device}")
    _check_cuda("attention_fwd", q, k, v, differentiable=True)
    B, h, N, d = q.shape
    M = k.shape[2]
    if k.shape[:2] != (B, h) or v.shape != k.shape:
        raise ValueError("attention_fwd: mismatched shapes")
    bias = _check_rows("attention_fwd bias", bias, (B, M))
    v_read, scratch = v, None
    if q.dtype == torch.bfloat16:
        ops, scratch, packed = hopper_operands((q, k, v))
        if packed[2] is not None:
            v_read = packed[2]
    else:
        buf, ((qp, *_), (kp, *_), (vp, *_)) = _pack_f32_launch(
            (q, k), (v,), kernel="attention_fwd")
    out = _heads_out(B, h, N, d, q)
    stats = torch.empty(2, B, h, N, dtype=torch.float32, device=q.device)
    lib = library("attention_fwd")
    with _on_device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if q.dtype == torch.bfloat16:
            err = lib.ei_attention_fwd_sm90(
                ops, bias.data_ptr(), out.data_ptr(),
                int64_array(out.stride()[:3]), stats.data_ptr(), B, h, N, M,
                float(scale), stream)
        else:
            err = lib.ei_attention_fwd_tf32(
                qp, kp, vp, bias.data_ptr(), out.data_ptr(),
                int64_array(out.stride()[:3]), stats.data_ptr(), B, h, N, M,
                float(scale), stream)
    check(err, "attention_fwd")
    hopper_attention.packs += scratch is not None
    attention_fwd.launches += 1
    return out, stats, v_read


def attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  do: torch.Tensor, bias: torch.Tensor, stats: torch.Tensor,
                  scale: float, blocks: int = 3
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel F: (dq, dk, dv) of kernel D, given its row statistics
    `stats` (2, B, h, N) and the output gradient `do` (cast to q's dtype).

    CPU tensors: the plain version (which recomputes the row statistics
    and c = rowsum(dP o P) as the TPU kernel does). CUDA tensors: the CUDA
    kernel, a c pass (c = rowsum(dP o P) in float32) and then the gradient
    loop (bfloat16: the Hopper loop, q, k, v and dO as `operand_plan`
    takes them; dO as autograd hands it may be any layout, and one the plan
    refuses is copied contiguous first; float32: the pack pass's row planes
    of q, k, v, dO and transposed planes of q, k, dO, one launch, then the
    3xTF32 loop), or an exception. `blocks` (on the card only) runs one of
    the loop's block kinds alone, after the c pass, to time it: 1 the
    dK/dV blocks, 2 the dQ blocks; the other gradients are then left
    unwritten."""
    do = do.to(q.dtype)
    if q.device.type == "cpu":
        return fused_attention_bwd_plain(q, k, v, bias, do, scale)
    if q.device.type != "cuda":
        raise ValueError(f"attention_bwd: unsupported device {q.device}")
    _check_cuda("attention_bwd", q, k, v, do, differentiable=True)
    B, h, N, d = q.shape
    M = k.shape[2]
    if k.shape[:2] != (B, h) or v.shape != k.shape or do.shape != q.shape:
        raise ValueError("attention_bwd: mismatched shapes")
    bias = _check_rows("attention_bwd bias", bias, (B, M))
    stats = _check_rows("attention_bwd stats", stats, (2, B, h, N))
    if blocks not in (1, 2, 3):
        raise ValueError(f"attention_bwd: blocks={blocks}; 1 or 2 time the "
                         f"loop's block kinds, 3 runs both")
    scratch = None
    if q.dtype == torch.bfloat16:
        try:
            operand_plan(do)
        except ValueError:
            do = do.contiguous()
        ops, scratch, _ = hopper_operands((q, k, v, do))
    else:
        buf, placed = _pack_f32_launch((q, k, v, do), (q, k, do),
                                       kernel="attention_bwd")
        planes = int64_array([ptr for ptr, _, _ in placed])
    dq = _heads_out(B, h, N, d, q)
    dk = _heads_out(B, h, M, d, q)
    dv = _heads_out(B, h, M, d, q)
    c = torch.empty(B, h, N, dtype=torch.float32, device=q.device)
    lib = library("attention_bwd")
    with _on_device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if q.dtype == torch.bfloat16:
            err = lib.ei_attention_bwd_sm90(
                ops, bias.data_ptr(), stats.data_ptr(), c.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                int64_array(dq.stride()[:3] + dk.stride()[:3]
                            + dv.stride()[:3]),
                B, h, N, M, float(scale), blocks, stream)
        else:
            err = lib.ei_attention_bwd_tf32(
                planes, bias.data_ptr(), stats.data_ptr(), c.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                int64_array(dq.stride()[:3] + dk.stride()[:3]
                            + dv.stride()[:3]),
                B, h, N, M, float(scale), blocks, stream)
    check(err, "attention_bwd")
    hopper_attention.packs += scratch is not None
    attention_bwd.launches += 1
    return dq, dk, dv


class _FusedAttention(torch.autograd.Function):
    """Forward: kernel D (saving q, k, the v it read, the bias and the row
    statistics); backward: kernel F, which reads D's packed v in place
    (bfloat16; in float32 F packs its own planes, so D's are freed with the
    forward). The bias gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale):
        out, stats, v_read = attention_fwd(q, k, v, bias, scale)
        ctx.save_for_backward(q, k, v_read, bias, stats)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, stats = ctx.saved_tensors
        dq, dk, dv = attention_bwd(q, k, v, do, bias, stats, ctx.scale)
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
hopper_attention.packs = 0
cross_attention_bidir.launches = 0
qblock_attention.launches = 0
attention_fwd.launches = 0
attention_bwd.launches = 0
