"""Kernel G: segment-masked flash attention, the counterpart of jax's TPU
flash attention forward (`jax.experimental.pallas.ops.tpu.flash_attention`)
as LightGlue's "flash" setting calls it (`_flash_attention` in
`ei_nexus_tpu/models/lightglue.py`).

`flash_attention(q, k, v, q_segment_ids, kv_segment_ids, sm_scale)`
launches the hand-written CUDA kernel (csrc/flash_segment.cu) on a CUDA
tensor and runs the plain PyTorch version `flash_attention_plain` on a CPU
tensor. Its function is the library kernel's, not kernels A/D's:

 - the float32 product of the operands times sm_scale, THEN the mask:
   -0.7 * float32 max added wherever a query's int32 segment id differs
   from the key's (a finite value, so a fully masked row averages V
   uniformly instead of turning NaN); no mask without segment ids;
 - an online softmax over key blocks of 128 whose probabilities
   P = exp(s - m) enter the PV product rounded to the value dtype BEFORE
   they are normalised; the accumulator is rescaled block by block.

The plain version repeats the library's arithmetic step for step (one key
block when M <= 128, where the library normalises P before the cast). The
kernel keeps its accumulator unnormalised over 64-key tiles and divides at
the end: equal up to float32 rounding. No N*M limit; ragged N and M are
masked in the kernel. d must be 64 on the card.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .attention_kernels import _check_cuda, _heads_out
from .cuda_build import check, int64_array, library

# jax's DEFAULT_MASK_VALUE (a Python float; float32 where it meets a score)
MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)
_BLOCK_K = 128  # the library's key block (BlockSizes.get_default)


def segment_ids_from_mask(kv_mask: Optional[torch.Tensor], n_q: int
                          ) -> Tuple[Optional[torch.Tensor],
                                     Optional[torch.Tensor]]:
    """LightGlue's key-side padding mask as segment ids: every query in
    segment 1, valid keys 1, invalid keys 2; (None, None) without a mask.
    kv_mask (B, M) bool -> (q ids (B, n_q), kv ids (B, M)) int32."""
    if kv_mask is None:
        return None, None
    q_seg = torch.ones(kv_mask.shape[0], n_q, dtype=torch.int32,
                       device=kv_mask.device)
    kv_seg = torch.where(kv_mask, 1, 2).to(torch.int32)
    return q_seg, kv_seg


def _mask_add(q_seg, kv_seg) -> Optional[torch.Tensor]:
    """(B, 1, N, M) float32: 0 where the ids agree, MASK_VALUE elsewhere."""
    if q_seg is None:
        return None
    same = q_seg[:, None, :, None] == kv_seg[:, None, None, :]
    return torch.where(same, 0.0, MASK_VALUE).to(torch.float32)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          q_segment_ids: Optional[torch.Tensor] = None,
                          kv_segment_ids: Optional[torch.Tensor] = None,
                          sm_scale: float = 1.0) -> torch.Tensor:
    """Plain PyTorch version of kernel G: q (B, h, N, d) over k, v
    (B, h, M, d), segment ids (B, N) and (B, M) int32 (both or neither),
    in the library kernel's arithmetic."""
    M = k.shape[2]
    add = _mask_add(q_segment_ids, kv_segment_ids)
    qf = q.float()

    def scores(k0, k1):
        s = torch.matmul(qf, k[:, :, k0:k1].float().mT)
        if sm_scale != 1.0:
            s = s * sm_scale
        return s if add is None else s + add[..., k0:k1]

    if M <= _BLOCK_K:
        # the library's single-step kernel: P normalised, then cast
        s = scores(0, M)
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        p = p / p.sum(dim=-1, keepdim=True)
        return torch.matmul(p.to(v.dtype).float(), v.float()).to(q.dtype)
    m = torch.full(q.shape[:3] + (1,), -torch.inf, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for k0 in range(0, M, _BLOCK_K):
        k1 = min(k0 + _BLOCK_K, M)
        s = scores(k0, k1)
        m_next = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_next)
        l_corr = torch.exp(m - m_next) * l
        l_next = p.sum(dim=-1, keepdim=True) + l_corr
        inv = torch.where(l_next == 0.0, 1.0, 1.0 / l_next)
        acc = acc * (l_corr * inv)
        acc = acc + torch.matmul(p.to(v.dtype).float(),
                                 v[:, :, k0:k1].float()) * inv
        m, l = m_next, l_next
    return acc.to(q.dtype)


def _check_ids(name: str, ids: torch.Tensor, shape, device) -> torch.Tensor:
    if tuple(ids.shape) != tuple(shape) or ids.dtype != torch.int32 \
            or ids.device != device:
        raise ValueError(f"{name}: expected int32 {tuple(shape)} segment ids "
                         f"on {device}, got {ids.dtype} {tuple(ids.shape)} "
                         f"on {ids.device}")
    return ids.contiguous()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_segment_ids: Optional[torch.Tensor] = None,
                    kv_segment_ids: Optional[torch.Tensor] = None,
                    sm_scale: float = 1.0) -> torch.Tensor:
    """Kernel G: q (B, h, N, d) over k, v (B, h, M, d) with jax's TPU
    flash-attention semantics; q_segment_ids (B, N) and kv_segment_ids
    (B, M) int32, both or neither (no mask).

    CPU tensors: the plain version. CUDA tensors: the CUDA kernel, or an
    exception (d must be 64)."""
    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise ValueError("flash_attention: give both segment ids or neither")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, q_segment_ids, kv_segment_ids,
                                     sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    code = _check_cuda("flash_attention", q, k, v)
    B, h, N, d = q.shape
    M = k.shape[2]
    if k.shape[:2] != (B, h) or v.shape != k.shape:
        raise ValueError("flash_attention: mismatched shapes")
    if q_segment_ids is None:
        # no mask: every id equal (the kernel adds exactly 0)
        q_segment_ids = torch.zeros(B, N, dtype=torch.int32, device=q.device)
        kv_segment_ids = torch.zeros(B, M, dtype=torch.int32,
                                     device=q.device)
    q_seg = _check_ids("flash_attention", q_segment_ids, (B, N), q.device)
    kv_seg = _check_ids("flash_attention", kv_segment_ids, (B, M), q.device)
    out = _heads_out(B, h, N, d, q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = library("flash_segment").ei_flash_segment(
            code, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            int64_array(q.stride() + k.stride() + v.stride()),
            q_seg.data_ptr(), kv_seg.data_ptr(), out.data_ptr(),
            int64_array(out.stride()), B, h, N, M, float(sm_scale), stream)
    check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
