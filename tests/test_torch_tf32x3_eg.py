"""The arithmetic of the float32 instances of kernels E and G (the 3xTF32
loop of `ei_nexus_tpu_torch/csrc/flash_tf32.cuh`, G in its segment mode)
on the CPU.

The loop cannot run here, so these tests hold what it computes over the
planes of `pack_f32_plain`, with the emulation of
`tests/test_torch_tf32x3.py` (`emulate_loop`: three split products a
matrix product, V^T's key order, float32 sums, the online softmax over
64-key tiles, exp(x - m) as exp2 of the difference times log2(e)):

 - E: the pack pass with the rotary and the loop at scale d^-0.5 (N == M),
   and the pack pass without it at scale 1 with N != M (a cross
   direction), against `qblock_attention_plain` and the JAX package's
   q-blocked Pallas kernels in interpret mode at block_q 64 and 128 (the
   card runs 64-row blocks at either, so one emulation answers both);
 - G: the loop with jax's segment rule in place of the bias (0 where the
   query's and the key's int32 ids agree, -0.7 x float32 max where they
   differ, -inf past M), against `flash_attention_plain` and jax's library
   TPU flash kernel under `pltpu.force_tpu_interpret_mode(True)`: random
   query and key segments, a batch row whose keys are all in a segment no
   query has (the mean of V), a row whose first 64 keys are all masked,
   and N, M that are not multiples of 64;
 - that the exp's form matters: x log2(e) - m log2(e) gives NaN on the
   fully masked row (-inf - (-inf)), where the loop's (x - m) log2(e)
   gives the mean of V.

Tolerance: 1e-4 x max(1, max|ref|), the port's float32 tolerance; the card
tests (`tests/test_torch_cuda.py`) hold the kernels themselves.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu.flash_attention import (BlockSizes,
                                                             SegmentIds,
                                                             flash_attention)

from ei_nexus_tpu.ops.pallas_attention import _qblock_attention
from ei_nexus_tpu_torch.ops import attention_kernels as ak
from ei_nexus_tpu_torch.ops import flash_kernel as fk
from tests import test_torch_tf32x3 as tf32x3
from tests.test_torch_threads import one_torch_thread  # noqa: F401
from tests.test_torch_tf32x3 import (_close, _exp_diff, _rot_tables, _t,
                                     emulate_loop)

D = 64


def _normal(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# E
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("block_q", [64, 128])
@pytest.mark.parametrize("case", ["rot", "rot-free"])
def test_qblock_loop_emulation(case, block_q):
    """E's float32 arithmetic: rot (N = M = 256, the pack pass rotating q
    and k, scale d^-0.5) or rot-free (N = 128 against M = 200 keys, scale
    1, pre-scaled operands); the last batch row's keys all masked (the mean
    of v)."""
    rng = np.random.default_rng(block_q + (case == "rot"))
    B, h = 2, 2
    N, M = (256, 256) if case == "rot" else (128, 200)
    pre = 1.0 if case == "rot" else D ** -0.25
    q, k = _normal(rng, B, h, N, D, scale=pre), _normal(rng, B, h, M, D,
                                                         scale=pre)
    v = _normal(rng, B, h, M, D)
    mask = rng.uniform(size=(B, M)) > 0.2
    mask[-1] = False
    scale = D ** -0.5 if case == "rot" else 1.0
    tables = _rot_tables(rng, B, N, D) if case == "rot" else None
    tq, tk, tv = _t(q), _t(k), _t(v)
    rot = None if tables is None else tuple(_t(a) for a in tables)
    bias = ak.key_bias(_t(mask), B, M, "cpu")
    (qp, kp), (vt,) = ak.pack_f32_plain((tq, tk), (tv,), rot)
    got = emulate_loop(qp, kp, vt, bias, scale)
    _close(got, ak.qblock_attention_plain(tq, tk, tv, bias, scale, rot))
    jax_out = _qblock_attention(
        *(jnp.asarray(a) for a in (q, k, v, bias[:, None].numpy())), scale,
        block_q, interpret=True,
        rot=None if tables is None else tuple(jnp.asarray(a)
                                              for a in tables))
    _close(got, jax_out)
    # the wrapper on CPU tensors: the plain version, whatever block_q
    _close(got, ak.qblock_attention(tq, tk, tv, bias, scale, block_q, rot))
    _close(got[-1], tv[-1].mean(dim=1, keepdim=True).expand(-1, N, -1))


# ---------------------------------------------------------------------------
# G
# ---------------------------------------------------------------------------


def _g_case(rng, B, h, N, M):
    """q, k (rotated outside, as LightGlue's "flash" path hands them), v,
    query ids in 0..2 and key ids in 0..2; batch row 1's keys all in
    segment 5, which no query has; batch row 0's first 64 keys in segment
    7, which no query has either."""
    q, k, v = (_normal(rng, B, h, n, D) for n in (N, M, M))
    q_seg = rng.integers(0, 3, (B, N)).astype(np.int32)
    kv_seg = rng.integers(0, 3, (B, M)).astype(np.int32)
    kv_seg[1] = 5
    kv_seg[0, :64] = 7
    return q, k, v, q_seg, kv_seg


def _flash_library(q, k, v, q_seg, kv_seg, sm_scale):
    """jax's library flash kernel in float32, interpreted: 128-key blocks,
    and 128-query blocks, or one block of all N queries where 128 does not
    divide N (the library's blocks must divide the token counts, and its
    key blocks be multiples of 128)."""
    N = q.shape[2]
    blocks = BlockSizes(block_q=128 if N % 128 == 0 else N,
                        block_k_major=128, block_k=128, block_b=1)
    seg = None if q_seg is None else SegmentIds(jnp.asarray(q_seg),
                                                jnp.asarray(kv_seg))
    with pltpu.force_tpu_interpret_mode(True):
        out = flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                              segment_ids=seg, sm_scale=sm_scale,
                              block_sizes=blocks)
    return np.asarray(out)


def _g_emulation(q, k, v, q_seg, kv_seg, scale):
    (qp, kp), (vt,) = ak.pack_f32_plain((_t(q), _t(k)), (_t(v),))
    add = fk._mask_add(_t(q_seg), _t(kv_seg))
    return emulate_loop(qp, kp, vt, add, scale)


@pytest.mark.parametrize("N,M,library", [(128, 256, True),
                                         (96, 256, True),
                                         (200, 136, False)])
def test_segment_loop_emulation(N, M, library):
    """G's float32 arithmetic against `flash_attention_plain` and, where
    M is a multiple of the library's 128-key blocks, jax's library flash
    kernel; N = 96 and 200 and M = 136 are not multiples of 64 (a ragged
    last query block, a ragged last key tile). The fully masked batch row
    is the mean of v; the row whose first tile is all masked is finite."""
    rng = np.random.default_rng(N + M)
    B, h, scale = 3, 2, D ** -0.5
    q, k, v, q_seg, kv_seg = _g_case(rng, B, h, N, M)
    got = _g_emulation(q, k, v, q_seg, kv_seg, scale)
    assert torch.isfinite(got).all()
    want = fk.flash_attention_plain(*(_t(a) for a in (q, k, v, q_seg,
                                                     kv_seg)), scale)
    _close(got, want)
    if library:
        _close(got, _flash_library(q, k, v, q_seg, kv_seg, scale))
    _close(got[1], _t(v[1]).mean(dim=1, keepdim=True).expand(-1, N, -1))


def test_segment_loop_emulation_without_ids():
    """A call without segment ids passes all-zero ids: no mask, against
    the plain version and the library kernel."""
    rng = np.random.default_rng(3)
    B, h, N, M = 1, 2, 128, 384
    q, k, v = (_normal(rng, B, h, n, D) for n in (N, M, M))
    zeros = np.zeros((B, N), np.int32), np.zeros((B, M), np.int32)
    got = _g_emulation(q, k, v, *zeros, 0.125)
    _close(got, fk.flash_attention_plain(_t(q), _t(k), _t(v),
                                         sm_scale=0.125))
    _close(got, _flash_library(q, k, v, None, None, 0.125))


def _exp_scaled_apart(x, m):
    """exp(x - m) with each side scaled by log2(e) before the difference:
    the form the loop must not take."""
    c = np.float32(1.4426950408889634)
    return torch.exp2(x * c - m * c)


def test_segment_loop_needs_the_difference_first(monkeypatch):
    """The emulation is sensitive to the exp's form: with x log2(e) -
    m log2(e), the fully masked row (every score -0.7 x float32 max, whose
    product with log2(e) overflows to -inf) and the row whose first tile
    is all masked turn NaN; the loop's (x - m) log2(e) gives the mean of V
    and finite values there."""
    rng = np.random.default_rng(11)
    B, h, N, M = 3, 2, 96, 200
    q, k, v, q_seg, kv_seg = _g_case(rng, B, h, N, M)
    scale = D ** -0.5
    mask = torch.tensor(fk.MASK_VALUE, dtype=torch.float32)
    assert float(_exp_diff(mask, mask)) == 1.0
    assert float(_exp_diff(mask, torch.tensor(3.0))) == 0.0
    right = _g_emulation(q, k, v, q_seg, kv_seg, scale)
    assert torch.isfinite(right).all()
    _close(right[1], _t(v[1]).mean(dim=1, keepdim=True).expand(-1, N, -1))
    monkeypatch.setattr(tf32x3, "_exp_diff", _exp_scaled_apart)
    wrong = _g_emulation(q, k, v, q_seg, kv_seg, scale)
    assert torch.isnan(wrong[1]).all()
    assert torch.isnan(wrong[0]).all()
    # rows without a masked first tile or a fully masked row stay right
    _close(wrong[2], right[2])
