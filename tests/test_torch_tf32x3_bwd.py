"""The arithmetic of the float32 instances of kernels D and F (the 3xTF32
loop of `ei_nexus_tpu_torch/csrc/flash_tf32.cuh` with its statistics
epilogue, and F's 3xTF32 blocks in `csrc/attention_bwd.cu`) on the CPU.

The kernels cannot run here, so these tests hold what they compute: the
pack pass's planes for F (`pack_f32_plain` with q, k, v, dO as row planes
and q, k, dO as transposed planes, each 8-token group in `vt_key_order`),
bit for bit; a test-local emulation of D's loop over its planes (split
products, 64-key tiles, the online softmax with its row max m and row sum
l) and of F's blocks over theirs: S in D's order and dP as split products,
P = exp(s - m) x (1/l) from D's m and l, c = rowsum(dP o P) summed a tile
at a time and across tiles compensated, dS = P o (dP - c) in float32, and
dQ += dS K, dK += dS^T Q, dV += P^T dO with dS and P split as the loops'
register fragments take them (their token columns in `vt_key_order`)
against the transposed planes. F's dK/dV blocks form S^T with K as the A
operand and D's terms in D's order; the emulation takes it as S transposed,
which the card tests hold (`tests/test_torch_cuda.py`).

Tolerances: 1e-4 x max(1, max|ref|) and a relative norm of 1e-4 (the port's
float32 bounds) against the plain versions and against `jax.grad` of the
JAX package's `fused_attention_vjp` with its Pallas kernels interpreted.
On the collapsed case dP - c is a hundredth of dP, so any float32
computation of F sits ~5e-5 from the exact gradients (the plain version
included), and two of them ~7e-5 from each other.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ei_nexus_tpu.ops.pallas_attention import fused_attention_vjp
from ei_nexus_tpu_torch.ops import attention_kernels as ak
from tests.test_torch_threads import one_torch_thread  # noqa: F401
from tests.torch_bwd_cases import bwd_case

TOL = 1e-4
D = 64
LOG2E = np.float32(1.4426950408889634)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _split_product(ah, al, bh, bl):
    """A B^T of split operands as the loops take it: the two small
    products, then the large one, each a float32 product, summed in
    float32."""
    return al @ bh.mT + ah @ bl.mT + ah @ bh.mT


def _exp_diff(x, m):
    """exp(x - m) as the loops take it: exp2 of the difference times
    log2(e), rounded to float32."""
    return torch.exp2((x - m) * LOG2E)


def _pad_keys(x, keys, fill=0.0):
    """x (.., n) padded to `keys` columns with `fill`."""
    out = torch.full((*x.shape[:-1], keys), fill, dtype=x.dtype)
    out[..., :x.shape[-1]] = x
    return out


def _tokens_split(x, keys):
    """The hi, lo A fragments of x (.., n) over tokens as the loops split
    them in registers: padded with zeros to `keys`, the columns taken in
    `vt_key_order`, each value split as the pack pass splits it."""
    return ak.tf32_split_plain(_pad_keys(x, keys)[..., ak.vt_key_order(keys)])


def emulate_fwd(qp, kp, vt, bias, scale):
    """D's 3xTF32 loop over its planes: qp (B, h, 2, N, 64), kp (B, h, 2,
    M, 64), vt (B, h, 2, 64, keys), bias (B, M). 64-key tiles; S = Qlo
    Khi^T + Qhi Klo^T + Qhi Khi^T, s = fl(fl(S x scale) + bias), -inf past
    M; the online softmax (m, l, O rescaled by exp(m_old - m_new)); P split
    with its columns in V^T's order; O / l. Returns (O, m, l)."""
    B, h, _, N, _ = qp.shape
    M, keys = kp.shape[3], vt.shape[-1]
    kpad = torch.zeros(B, h, 2, keys, D)
    kpad[:, :, :, :M] = kp
    bpad = _pad_keys(bias, keys, -torch.inf)
    o = torch.zeros(B, h, N, D)
    m = torch.full((B, h, N), -torch.inf)
    l = torch.zeros(B, h, N)
    for k0 in range(0, keys, 64):
        t = slice(k0, k0 + 64)
        s = _split_product(qp[:, :, 0], qp[:, :, 1], kpad[:, :, 0, t],
                           kpad[:, :, 1, t])
        s = s * scale + bpad[:, None, None, t]
        m_new = torch.maximum(m, s.amax(-1))
        alpha = _exp_diff(m, m_new)
        p = _exp_diff(s, m_new[..., None])
        l = l * alpha + p.sum(-1)
        m = m_new
        ph, pl = ak.tf32_split_plain(p[..., ak.vt_key_order(64)])
        o = o * alpha[..., None] + _split_product(ph, pl, vt[:, :, 0, :, t],
                                                  vt[:, :, 1, :, t])
    return o / torch.where(l == 0, 1.0, l)[..., None], m, l


def emulate_bwd(rows, cols, bias, m, l, scale):
    """F's 3xTF32 blocks over its planes: rows = the (B, h, 2, n, 64) row
    planes of q, k, v, dO; cols = the (B, h, 2, 64, n rounded up to 64)
    transposed planes of q, k, dO; bias (B, M); D's row max m and row sum
    l (B, h, N). Returns (dq, dk, dv)."""
    qp, kp, vp, dop = rows
    qt, kt, dot = cols
    N, M = qp.shape[3], kp.shape[3]
    qkeys, kkeys = qt.shape[-1], kt.shape[-1]
    s = _split_product(qp[:, :, 0], qp[:, :, 1], kp[:, :, 0], kp[:, :, 1])
    p = _exp_diff(s * scale + bias[:, None, None], m[..., None]) \
        * (1.0 / l)[..., None]
    dp = _split_product(dop[:, :, 0], dop[:, :, 1], vp[:, :, 0], vp[:, :, 1])
    # c: a 64-key tile's part at a time, the parts summed compensated
    c = torch.zeros_like(m)
    lost = torch.zeros_like(m)
    for k0 in range(0, M, 64):
        part = (p[..., k0:k0 + 64] * dp[..., k0:k0 + 64]).sum(-1)
        y = part - lost
        total = c + y
        lost = (total - c) - y
        c = total
    ds = p * (dp - c[..., None])
    # the gradient products a tile at a time, as the blocks accumulate
    dq = torch.zeros(*m.shape, D)
    for k0 in range(0, kkeys, 64):
        t = slice(k0, k0 + 64)
        ah, al = _tokens_split(ds, kkeys)
        dq += _split_product(ah[..., t], al[..., t], kt[:, :, 0, :, t],
                             kt[:, :, 1, :, t])
    dk = torch.zeros(*kp.shape[:2], M, D)
    dv = torch.zeros(*kp.shape[:2], M, D)
    dsh, dsl = _tokens_split(ds.mT, qkeys)
    ph, pl = _tokens_split(p.mT, qkeys)
    for q0 in range(0, qkeys, 64):
        t = slice(q0, q0 + 64)
        dk += _split_product(dsh[..., t], dsl[..., t], qt[:, :, 0, :, t],
                             qt[:, :, 1, :, t])
        dv += _split_product(ph[..., t], pl[..., t], dot[:, :, 0, :, t],
                             dot[:, :, 1, :, t])
    return dq * scale, dk * scale, dv


def _operands(values, B, h, N, M, scale, seed):
    """(q, k, v, do, mask) float32 arrays: "normal" random values with the
    last batch row's keys all masked, or a case of
    `tests/torch_bwd_cases.py` (collapsed value rows, one-hot rows); q and
    k pre-scaled by d^-0.25 for scale 1, as the cross-attention hands
    them."""
    pre = np.float32(D ** -0.25 if scale == 1.0 else 1.0)
    if values != "normal":
        q, k, v, do, mask = bwd_case(values, B, h, N, M, D, seed)
        return q * pre, k * pre, v, do, mask
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.normal(size=(B, h, n, D)) * s
                   for n, s in ((N, pre), (M, pre), (M, 1.0), (N, 1.0)))
    mask = rng.uniform(size=(B, M)) > 0.2
    mask[-1] = False
    return (*(a.astype(np.float32) for a in (q, k, v, do)), mask)


def _rel(a, b) -> float:
    a, b = (np.asarray(x, np.float64) for x in (a, b))
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    bound = tol * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= bound, (err, bound)


def _jax_grads(q, k, v, do, mask, scale):
    """dq, dk, dv of `fused_attention_vjp` with the Pallas kernels
    interpreted, for the output gradient do."""
    def loss(q, k, v):
        out = fused_attention_vjp(q, k, v, jnp.asarray(mask), scale=scale,
                                  interpret=True)
        return jnp.sum(out * do)

    grads = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))
    return [np.asarray(g) for g in grads]


def _emulate(q, k, v, do, mask, scale, cols_natural=()):
    """D then F emulated on the planes of the pack pass's plain version;
    the operands named in cols_natural ("q", "k", "do") keep their
    transposed planes in the natural token order."""
    tq, tk, tv, tdo = (_t(a) for a in (q, k, v, do))
    B, M = mask.shape
    bias = ak.key_bias(_t(mask), B, M, "cpu")
    (qp, kp), (vt,) = ak.pack_f32_plain((tq, tk), (tv,))
    out, m, l = emulate_fwd(qp, kp, vt, bias, scale)
    rows, cols = ak.pack_f32_plain((tq, tk, tv, tdo), (tq, tk, tdo))
    cols = list(cols)
    for i, name in enumerate(("q", "k", "do")):
        if name in cols_natural:
            x = (tq, tk, tdo)[i]
            keys = cols[i].shape[-1]
            cols[i] = torch.stack(ak.tf32_split_plain(
                _pad_keys(x.mT, keys)), dim=2)
    return out, m, l, emulate_bwd(rows, cols, bias, m, l, scale), bias


def test_f_pack_planes_bit_layout():
    """F's planes: each row plane holds its operand's hi and lo split bit
    for bit; position p of each transposed plane holds token
    `vt_key_order(keys)[p]`, hi and lo bit for bit, zeros past the last
    token (ragged N != M)."""
    rng = np.random.default_rng(0)
    B, h, N, M = 2, 2, 70, 100
    q, do = (_t(rng.normal(size=(B, h, N, D)).astype(np.float32))
             for _ in range(2))
    k, v = (_t(rng.normal(size=(B, h, M, D)).astype(np.float32))
            for _ in range(2))
    rows, cols = ak.pack_f32_plain((q, k, v, do), (q, k, do))
    for x, plane in zip((q, k, v, do), rows):
        assert plane.shape == (B, h, 2, x.shape[2], D)
        hi, lo = ak.tf32_split_plain(x)
        assert torch.equal(plane[:, :, 0].view(torch.int32),
                           hi.view(torch.int32))
        assert torch.equal(plane[:, :, 1].view(torch.int32),
                           lo.view(torch.int32))
    for x, plane in zip((q, k, do), cols):
        n = x.shape[2]
        keys = -(-n // 64) * 64
        assert plane.shape == (B, h, 2, D, keys)
        order = ak.vt_key_order(keys)
        hi, lo = ak.tf32_split_plain(x)
        for pos in range(keys):
            tok = int(order[pos])
            for part, want in ((0, hi), (1, lo)):
                got = plane[:, :, part, :, pos]
                if tok < n:
                    assert torch.equal(got.view(torch.int32),
                                       want[:, :, tok].view(torch.int32))
                else:
                    assert not got.any()


@pytest.mark.parametrize("N,M,scale", [(128, 128, D ** -0.5),
                                       (96, 160, 1.0)])
@pytest.mark.parametrize("values", ["normal", "one-hot"])
def test_d_loop_emulation_and_stats(N, M, scale, values):
    """D's float32 loop: O against `fused_attention_plain` and the JAX
    package's `_generic_fwd_kernel` in interpret mode; m and l against
    the plain version's row statistics (`attention_fwd` on the CPU) to
    relative 1e-5 (m against max(1, |m|)); the fully masked batch row has
    m = -1e9 and l = M exactly. On one-hot rows (|s| ~ 260, ulp 3e-5) l is
    1 plus exponentials of scores whose float32 rounding differs between
    any two orders of the product by ~1e-4 of the exponent: l there to
    relative 1e-4."""
    q, k, v, do, mask = _operands(values, 2, 2, N, M, scale, seed=N + M)
    out, m, l, _, bias = _emulate(q, k, v, do, mask, scale)
    tq, tk, tv = (_t(a) for a in (q, k, v))
    _close(out, ak.fused_attention_plain(tq, tk, tv, _t(mask), scale))
    jax_out = fused_attention_vjp(*(jnp.asarray(a) for a in (q, k, v, mask)),
                                  scale=scale, interpret=True)
    _close(out, jax_out)
    _, stats, _ = ak.attention_fwd(tq, tk, tv, bias, scale)
    assert bool(((m - stats[0]).abs()
                 <= 1e-5 * stats[0].abs().clamp(min=1.0)).all())
    l_tol = 1e-4 if values == "one-hot" else 1e-5
    assert bool(((l - stats[1]).abs() <= l_tol * stats[1]).all())
    if values == "normal":
        assert bool((m[-1] == -1e9).all()) and bool((l[-1] == M).all())


@pytest.mark.parametrize("N,M,scale", [(128, 128, D ** -0.5),
                                       (96, 160, 1.0)])
@pytest.mark.parametrize("values", ["normal", "collapsed", "one-hot"])
def test_f_blocks_emulation(N, M, scale, values):
    """F's float32 blocks from D's m and l: dq, dk, dv against
    `fused_attention_bwd_plain` and against `jax.grad` of the interpreted
    `fused_attention_vjp`, within 1e-4 x max(1, max|ref|) and a relative
    norm of 1e-4; on "normal" the fully masked batch row alone too (its
    softmax uniform, 1/M a key); where dP - c cancels (collapsed value
    rows, one-hot rows) as everywhere else."""
    q, k, v, do, mask = _operands(values, 2, 2, N, M, scale, seed=N + M)
    _, _, _, got, bias = _emulate(q, k, v, do, mask, scale)
    want = ak.fused_attention_bwd_plain(*(_t(a) for a in (q, k, v)), bias,
                                        _t(do), scale)
    jax_want = _jax_grads(q, k, v, do, mask, scale)
    for name, a, b, j in zip(("dq", "dk", "dv"), got, want, jax_want):
        for ref in (b.numpy(), j):
            _close(a, ref)
            assert _rel(a, ref) <= TOL, (name, _rel(a, ref))
        if values == "normal":
            _close(a[-1], b[-1])
            assert _rel(a[-1], b[-1]) <= TOL, name


@pytest.mark.parametrize("natural", ["q", "k", "do"])
def test_f_emulation_needs_the_token_order(natural):
    """The emulation is sensitive to what it checks: a transposed plane
    (Q^T for dK, K^T for dQ, dO^T for dV) left in the natural token order,
    against the fragments' permuted columns, misses the plain version by
    far more than the tolerance."""
    scale = D ** -0.5
    q, k, v, do, mask = _operands("normal", 2, 2, 128, 128, scale, seed=7)
    _, _, _, good, bias = _emulate(q, k, v, do, mask, scale)
    _, _, _, bad, _ = _emulate(q, k, v, do, mask, scale,
                               cols_natural=(natural,))
    want = ak.fused_attention_bwd_plain(*(_t(a) for a in (q, k, v)), bias,
                                        _t(do), scale)
    hit = {"q": 1, "k": 0, "do": 2}[natural]
    for i, (g, b, w) in enumerate(zip(good, bad, want)):
        assert _rel(g, w) <= TOL
        if i == hit:
            assert _rel(b, w) > 100 * TOL
        else:
            assert torch.equal(b, g)
