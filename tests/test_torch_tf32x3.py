"""The arithmetic of the float32 instances of kernels A and B (the 3xTF32
loop of `ei_nexus_tpu_torch/csrc/flash_tf32.cuh`) on the CPU.

The loop cannot run here, so these tests hold what it computes:
`tf32_split_plain` (the pack pass's split x = hi + lo, cvt.rna.tf32.f32's
rounding), `pack_f32_plain` (the rotated, split Q and K planes and the
permuted, split V^T planes) and a test-local emulation of the loop over
those planes: three split products a matrix product, the key order of
V^T, float32 sums, the online softmax over 64-key tiles. The emulation is
held within 1e-4 x max(1, max|ref|) (the port's float32 tolerance) of the
plain versions and of the JAX package's Pallas kernels in interpret mode;
the card tests (`tests/test_torch_cuda.py`) hold the kernels themselves.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ei_nexus_tpu.ops.pallas_attention import (cross_attention_bidir,
                                               self_attention)
from ei_nexus_tpu_torch.ops import attention_kernels as ak
from tests.test_torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-4


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def test_tf32_split_bits_and_residual():
    """hi and lo have their 13 low bits clear and x - hi - lo stays within
    2^-22 |x|, over values of many magnitudes and both signs."""
    rng = np.random.default_rng(0)
    x = (rng.normal(size=20000) * 10.0 ** rng.uniform(-20, 20, 20000))
    x = _t(x.astype(np.float32))
    hi, lo = ak.tf32_split_plain(x)
    assert int((_bits(hi) & 0x1FFF).abs().max()) == 0
    assert int((_bits(lo) & 0x1FFF).abs().max()) == 0
    resid = (x.double() - hi.double() - lo.double()).abs()
    assert bool((resid <= 2.0 ** -22 * x.double().abs()).all())
    # hi is the nearest TF32 value: within half a TF32 step of x
    step = 2.0 ** (torch.floor(torch.log2(x.double().abs())) - 10)
    assert bool(((x.double() - hi.double()).abs() <= step / 2).all())


def test_tf32_split_ties_round_away_from_zero():
    """A value halfway between two TF32 values rounds to the one of larger
    magnitude, for either sign, as cvt.rna does."""
    rng = np.random.default_rng(1)
    base = rng.integers(0x3F000000, 0x41000000, 1000, dtype=np.int64)
    tie = (base & ~0x1FFF) | 0x1000          # the 13 low bits: exactly half
    for sign in (0, np.int64(1) << 31):
        bits = (tie | sign).astype(np.uint32).view(np.int32)
        x = _t(bits).view(torch.float32)
        hi, _ = ak.tf32_split_plain(x)
        up = _t(((tie + 0x1000) | sign).astype(np.uint32).view(np.int32))
        assert torch.equal(_bits(hi), up)
    # and below the half, towards the smaller magnitude
    x = _t(((base & ~0x1FFF) | 0x0FFF).astype(np.uint32).view(np.int32))
    hi, _ = ak.tf32_split_plain(x.view(torch.float32))
    assert torch.equal(_bits(hi), _t((base & ~0x1FFF).astype(np.int32)))


def test_pack_f32_plain_layout():
    """Q/K planes: the rotated operand split; V^T planes: position p of
    each row holds key `vt_key_order(keys)[p]`, zeros for keys past n."""
    rng = np.random.default_rng(2)
    B, h, n, d = 2, 3, 70, 64
    q = _t(rng.normal(size=(B, h, n, d)).astype(np.float32))
    v = _t(rng.normal(size=(B, h, n, d)).astype(np.float32))
    cos, sin = (_t(a) for a in _rot_tables(rng, B, n, d))
    (qp,), (vt,) = ak.pack_f32_plain((q,), (v,), (cos, sin))
    assert qp.shape == (B, h, 2, n, d) and vt.shape == (B, h, 2, d, 128)
    rq = q * cos[:, None] + ak.rotate_half(q) * sin[:, None]
    assert torch.equal(qp[:, :, 0], ak.tf32_split_plain(rq)[0])
    resid = (qp[:, :, 0].double() + qp[:, :, 1].double() - rq.double()).abs()
    assert bool((resid <= 2.0 ** -22 * rq.double().abs()).all())
    order = ak.vt_key_order(128)
    assert sorted(order.tolist()) == list(range(128))
    for p in (0, 1, 3, 4, 7, 9, 69, 71, 127):
        key = int(order[p])
        want = v[:, :, key] if key < n else torch.zeros(B, h, d)
        got = vt[:, :, 0, :, p] + vt[:, :, 1, :, p]
        assert (got - want).abs().max() <= 2.0 ** -22 * want.abs().max()


def _rot_tables(rng, B, N, d):
    ang = rng.uniform(0, 2 * np.pi, (B, N, d // 2)).astype(np.float32)
    return (np.repeat(np.cos(ang), 2, axis=-1),
            np.repeat(np.sin(ang), 2, axis=-1))


def _split_product(ah, al, bh, bl):
    """The loop's product A B^T of split operands: the two small products,
    then the large one, each a float32 product, summed in float32."""
    return al @ bh.mT + ah @ bl.mT + ah @ bh.mT


def _exp_diff(x, m):
    """exp(x - m) as the loop takes it: exp2 of the difference times
    log2(e), rounded to float32 (0 where x is -inf)."""
    return torch.exp2((x - m) * np.float32(1.4426950408889634))


def emulate_loop(qp, kp, vt, bias, scale):
    """The 3xTF32 loop over the pack pass's planes: qp (B, h, 2, N, 64), kp
    (B, h, 2, M, 64), vt (B, h, 2, 64, keys), bias (B, M) float32, or
    (B, 1, N, M) where the term depends on the query too (G's segment
    rule). 64-key tiles; S split products, s = fl(fl(S x scale) + bias),
    -inf past M; online softmax (m, l, O rescaled by exp(m_old - m_new),
    exp(x - m) as exp2(fl((x - m) log2(e)))); P split and its columns taken
    in V^T's key order; O / l at the end."""
    B, h, _, N, d = qp.shape
    M, keys = kp.shape[3], vt.shape[-1]
    kpad = torch.zeros(B, h, 2, keys, d)
    kpad[:, :, :, :M] = kp
    add = bias[:, None, None] if bias.ndim == 2 else bias
    bpad = torch.full(add.shape[:-1] + (keys,), -torch.inf)
    bpad[..., :M] = add
    order = ak.vt_key_order(keys)
    o = torch.zeros(B, h, N, d)
    m = torch.full((B, h, N), -torch.inf)
    l = torch.zeros(B, h, N)
    for k0 in range(0, keys, 64):
        t = slice(k0, k0 + 64)
        s = _split_product(qp[:, :, 0], qp[:, :, 1], kpad[:, :, 0, t],
                           kpad[:, :, 1, t])
        s = s * scale + bpad[..., t]
        m_new = torch.maximum(m, s.amax(-1))
        alpha = _exp_diff(m, m_new)
        p = _exp_diff(s, m_new[..., None])
        l = l * alpha + p.sum(-1)
        m = m_new
        ph, pl = ak.tf32_split_plain(p[..., order[t] - k0])
        vh, vl = vt[:, :, 0, :, t], vt[:, :, 1, :, t]
        o = o * alpha[..., None] + _split_product(ph, pl, vh, vl)
    return o / torch.where(l == 0, 1.0, l)[..., None]


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    bound = tol * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= bound, (err, bound)


def _operands(rng, B, h, N, M, values):
    """q (B, h, N, 64), k and v (B, h, M, 64) with a key mask: "random"
    with the last batch row's keys all masked, or "one-hot": q a multiple
    of k's matching row, so each query's own key scores far above the
    rest (no fully masked row: its scores must round to -1e9)."""
    d = 64
    k = rng.normal(size=(B, h, M, d)).astype(np.float32)
    v = rng.normal(size=(B, h, M, d)).astype(np.float32)
    mask = rng.uniform(size=(B, M)) > 0.2
    if values == "one-hot":
        q = 3.0 * k[:, :, :N] + 0.1 * rng.normal(size=(B, h, N, d))
        mask[:, :N] = True
    else:
        q = rng.normal(size=(B, h, N, d))
        mask[-1] = False
    return q.astype(np.float32), k, v, mask


@pytest.mark.parametrize("N", [64, 200])
@pytest.mark.parametrize("values", ["random", "one-hot"])
def test_loop_emulation_self_attention(N, values):
    """Kernel A's float32 arithmetic (rotary in the pack pass, scale
    d^-0.5) against `self_attention_plain` and the JAX package's
    whole-problem rotary kernel in interpret mode."""
    rng = np.random.default_rng(N)
    B, h, d = 2, 2, 64
    q, k, v, mask = _operands(rng, B, h, N, N, values)
    cos, sin = _rot_tables(rng, B, N, d)
    tq, tk, tv = _t(q), _t(k), _t(v)
    rot = (_t(cos), _t(sin))
    (qp, kp), (vt,) = ak.pack_f32_plain((tq, tk), (tv,), rot)
    bias = ak.key_bias(_t(mask), B, N, "cpu")
    got = emulate_loop(qp, kp, vt, bias, d ** -0.5)
    want = ak.self_attention_plain(tq, tk, tv, _t(mask), rot=rot)
    _close(got, want)
    jax_out = self_attention(*(jnp.asarray(a) for a in (q, k, v, mask)),
                             interpret=True, block_q=0,
                             rot=(jnp.asarray(cos), jnp.asarray(sin)))
    _close(got, jax_out)
    if values == "one-hot":
        # each row's own key holds nearly all of its softmax
        s = ak._rotate(tq, rot) @ ak._rotate(tk, rot).mT * d ** -0.5
        top = torch.softmax(s, -1).diagonal(dim1=-2, dim2=-1)
        assert float(top.min()) > 0.99
    else:
        # the fully masked batch row: the uniform average of v
        _close(got[-1], tv[-1].mean(dim=1, keepdim=True).expand(-1, N, -1))


@pytest.mark.parametrize("N,M", [(96, 160), (64, 320)])
@pytest.mark.parametrize("values", ["random", "one-hot"])
def test_loop_emulation_cross_attention(N, M, values):
    """Kernel B's float32 arithmetic, both directions from one packing of
    each side (scale 1, pre-scaled operands), against
    `cross_attention_bidir_plain` and the JAX package's `_cross_kernel` in
    interpret mode."""
    rng = np.random.default_rng(N + M)
    B, h, d = 2, 2, 64
    s = d ** -0.25
    qk0, qk1, v1, mask1 = _operands(rng, B, h, N, M, values)
    qk0, qk1 = qk0 * s, qk1 * s
    v0 = rng.normal(size=(B, h, N, d)).astype(np.float32)
    mask0 = rng.uniform(size=(B, N)) > 0.2
    t = [_t(a) for a in (qk0, qk1, v0, v1, mask0, mask1)]
    (p0, p1), (vt0, vt1) = ak.pack_f32_plain(t[:2], t[2:4])
    g0 = emulate_loop(p0, p1, vt1, ak.key_bias(t[5], B, M, "cpu"), 1.0)
    g1 = emulate_loop(p1, p0, vt0, ak.key_bias(t[4], B, N, "cpu"), 1.0)
    w0, w1 = ak.cross_attention_bidir_plain(*t)
    _close(g0, w0)
    _close(g1, w1)
    j0, j1 = cross_attention_bidir(*(jnp.asarray(a) for a in
                                     (qk0, qk1, v0, v1, mask0, mask1)),
                                   interpret=True, block_q=0)
    _close(g0, j0)
    _close(g1, j1)
    if values == "random":
        # side 1's last batch row is fully masked: side 0's queries there
        # average v1 uniformly
        _close(g0[-1], t[3][-1].mean(dim=1, keepdim=True).expand(-1, N, -1))


def test_emulation_needs_the_key_order():
    """The emulation is sensitive to what it checks: V^T in the natural
    key order, with P's columns in the loop's order, misses the plain
    version by far more than the tolerance."""
    rng = np.random.default_rng(5)
    B, h, N, d = 1, 2, 128, 64
    q, k, v, mask = _operands(rng, B, h, N, N, "one-hot")
    tq, tk, tv = _t(q), _t(k), _t(v)
    (qp, kp), (vt,) = ak.pack_f32_plain((tq, tk), (tv,))
    natural = torch.stack(ak.tf32_split_plain(tv.mT), dim=2)
    bias = ak.key_bias(_t(mask), B, N, "cpu")
    want = ak.fused_attention_plain(tq, tk, tv, _t(mask))
    _close(emulate_loop(qp, kp, vt, bias, d ** -0.5), want)
    err = (emulate_loop(qp, kp, natural, bias, d ** -0.5) - want).abs().max()
    assert float(err) > 100 * TOL
