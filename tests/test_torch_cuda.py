"""The port's CUDA kernels against their plain versions on the card (marked
`cuda`; they skip on a host without one; `python3 chip_smoke.py` holds the
same kernels at the main path's shapes).

Run on the card: python -m pytest tests/test_torch_cuda.py -q -m cuda
(add --noconftest where JAX is not installed: tests/conftest.py imports it)

Tolerances: float32 atol 1e-4 (the kernels' float32 sums run in another
order and their softmax is online); bfloat16 atol 2e-2 (the kernels round
the unnormalised probabilities to bfloat16, the plain version the
normalised ones), times max(1, max|ref|) for E and G; NMS bit-exact. The
pose tail on the card is held to the CPU in float64 (R, t to 1e-4). The backward (kernel F) is held to
1e-4 * max(1, max|ref|) in float32 and 2e-2 * max(1, max|ref|) in bfloat16:
its c = rowsum(dO o O) reads the output rounded to the operand type where
the plain version sums dP o P, and its P = exp(S - lse) uses the forward's
log-sum-exp; no atomics, so it repeats exactly from run to run. A typical
gradient entry is far below 1, so each gradient is also held to a relative
norm, ||got - want|| / ||want|| <= 1e-4 (float32) or 1e-2 (bfloat16, whose
rounding of the outputs alone gives ~2e-3); planted faults (c = 0, c or the
log-sum-exp read from the neighbouring row) move it by 6e-2 or more.
"""

import pytest
import torch

from ei_nexus_tpu_torch.ops import attention_kernels as ak
from ei_nexus_tpu_torch.ops import nms_kernel as nk

pytestmark = pytest.mark.cuda

# relative-norm bound of kernel F's gradients, by operand type
BWD_REL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b|| over the whole tensor."""
    return float((a.float() - b.float()).norm() / b.float().norm())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("N", [64, 200])
def test_self_attention_kernel(cuda, dtype, tol, N):
    B, h, d = 2, 3, 64
    qkv = torch.randn(B, N, h * d * 3, generator=cuda, device="cuda").to(
        dtype).unflatten(-1, (h, d, 3)).transpose(1, 2)
    q, k, v = qkv[..., 0], qkv[..., 1], qkv[..., 2]
    ang = torch.rand(B, N, d // 2, generator=cuda, device="cuda") * 6.28
    rot = tuple(torch.repeat_interleave(f(ang), 2, -1).to(dtype)
                for f in (torch.cos, torch.sin))
    mask = torch.rand(B, N, generator=cuda, device="cuda") > 0.2
    before = ak.self_attention.launches
    got = ak.self_attention(q, k, v, mask, rot=rot)
    assert ak.self_attention.launches == before + 1
    want = ak.self_attention_plain(q, k, v, mask, rot=rot)
    assert (got.float() - want.float()).abs().max() <= tol


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_cross_attention_kernel(cuda, dtype, tol):
    B, h, N, M, d = 2, 2, 96, 160, 64

    def heads(n):
        return torch.randn(B, n, h * d, generator=cuda, device="cuda").to(
            dtype).unflatten(-1, (h, d)).transpose(1, 2)
    qk0, qk1 = heads(N) * d ** -0.25, heads(M) * d ** -0.25
    v0, v1 = heads(N), heads(M)
    m0 = torch.rand(B, N, generator=cuda, device="cuda") > 0.2
    m1 = torch.rand(B, M, generator=cuda, device="cuda") > 0.2
    g0, g1 = ak.cross_attention_bidir(qk0, qk1, v0, v1, m0, m1)
    w0, w1 = ak.cross_attention_bidir_plain(qk0, qk1, v0, v1, m0, m1)
    assert (g0.float() - w0.float()).abs().max() <= tol
    assert (g1.float() - w1.float()).abs().max() <= tol


@pytest.mark.parametrize("shape,radius,n_iter", [((2, 70, 90), 4, 4),
                                                 ((1, 264, 352), 4, 4),
                                                 ((3, 33, 47), 2, 3),
                                                 ((24, 264, 352), 4, 4)])
def test_nms_kernel_bit_exact(cuda, shape, radius, n_iter):
    """Bit-exact against the plain version; the last shape has more tiles
    than blocks fit on the card at once, so blocks take several tiles."""
    s = torch.rand(*shape, generator=cuda, device="cuda")
    s = torch.where(s > 0.4, s, torch.zeros_like(s))
    assert torch.equal(nk.nms_rounds(s, radius, n_iter),
                       nk.nms_rounds_plain(s, radius, n_iter))


def _strided_heads(gen, B, n, h, d, dtype, which=0):
    """(B, h, n, d) view at stride 3 of a (B, n, h, d, 3) buffer, as
    SelfBlock's Wqkv split produces."""
    x = torch.randn(B, n, h * d * 3, generator=gen, device="cuda")
    return x.to(dtype).unflatten(-1, (h, d, 3)).transpose(1, 2)[..., which]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("N,M,scale", [(200, 136, 0.125), (64, 320, 1.0)])
def test_attention_fwd_kernel(cuda, dtype, tol, N, M, scale):
    B, h, d = 2, 3, 64
    q = _strided_heads(cuda, B, N, h, d, dtype)
    k = _strided_heads(cuda, B, M, h, d, dtype, 1)
    v = _strided_heads(cuda, B, M, h, d, dtype, 2)
    mask = torch.rand(B, M, generator=cuda, device="cuda") > 0.2
    bias = ak.key_bias(mask, B, M, "cuda")
    before = ak.attention_fwd.launches
    out, lse = ak.attention_fwd(q, k, v, bias, scale)
    assert ak.attention_fwd.launches == before + 1
    want = ak.fused_attention_plain(q, k, v, mask, scale)
    s = torch.matmul(q.float(), k.float().mT) * scale + bias[:, None, None]
    assert (out.float() - want.float()).abs().max() <= tol
    assert (lse - torch.logsumexp(s, -1)).abs().max() <= 1e-4 * max(
        1.0, float(lse.abs().max()))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("N,M,scale", [(200, 136, 0.125), (128, 256, 1.0)])
def test_attention_bwd_kernel(cuda, dtype, tol, N, M, scale):
    B, h, d = 2, 2, 64
    q = _strided_heads(cuda, B, N, h, d, dtype)
    k = _strided_heads(cuda, B, M, h, d, dtype, 1)
    v = _strided_heads(cuda, B, M, h, d, dtype, 2)
    mask = torch.rand(B, M, generator=cuda, device="cuda") > 0.2
    bias = ak.key_bias(mask, B, M, "cuda")
    out, lse = ak.attention_fwd(q, k, v, bias, scale)
    do = torch.randn(B, h, N, d, generator=cuda, device="cuda").to(dtype)
    before = ak.attention_bwd.launches
    got = ak.attention_bwd(q, k, v, out, do, bias, lse, scale)
    assert ak.attention_bwd.launches == before + 1
    want = ak.fused_attention_bwd_plain(q, k, v, bias, do, scale)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        bound = tol * max(1.0, float(b.float().abs().max()))
        assert (a.float() - b.float()).abs().max() <= bound, name
        assert _rel(a, b) <= BWD_REL[dtype], name
    # the same inputs give the same bits: no atomics in the sums
    again = ak.attention_bwd(q, k, v, out, do, bias, lse, scale)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_bwd_check_catches_planted_faults(cuda, dtype):
    """The relative-norm check of test_attention_bwd_kernel fails when F
    drops c (a zero output zeroes c = rowsum(dO o O)), or reads c or the
    log-sum-exp of the neighbouring row, at the flagship's self-attention
    statistics (scale d^-0.5, ~80% of 1024 keys live)."""
    B, h, N, M, d = 1, 2, 1024, 1024, 64
    q = _strided_heads(cuda, B, N, h, d, dtype)
    k = _strided_heads(cuda, B, M, h, d, dtype, 1)
    v = _strided_heads(cuda, B, M, h, d, dtype, 2)
    mask = torch.rand(B, M, generator=cuda, device="cuda") > 0.2
    bias = ak.key_bias(mask, B, M, "cuda")
    out, lse = ak.attention_fwd(q, k, v, bias, d ** -0.5)
    do = torch.randn(B, h, N, d, generator=cuda, device="cuda").to(dtype)
    want = ak.fused_attention_bwd_plain(q, k, v, bias, do, d ** -0.5)
    for fault, o, l in (("c = 0", torch.zeros_like(out), lse),
                        ("c of the next row", out.roll(1, 2), lse),
                        ("lse of the next row", out, lse.roll(1, 2))):
        got = ak.attention_bwd(q, k, v, o, do, bias, l, d ** -0.5)
        worst = max(_rel(a, b) for a, b in zip(got, want))
        assert worst > 5 * BWD_REL[dtype], fault


def test_fused_attention_shared_qk_gradient(cuda):
    """Cross-attention's shared qk receives the sum of its query-role and
    key-role gradients through autograd across the two kernel calls; the
    card (kernels D, F) agrees with the CPU (plain versions)."""
    B, h, N, M, d = 2, 2, 96, 160, 64
    g = torch.Generator().manual_seed(1)
    qk0, qk1 = (torch.randn(B, h, n, d, generator=g) * d ** -0.25
                for n in (N, M))
    v0, v1 = torch.randn(B, h, N, d, generator=g), torch.randn(
        B, h, M, d, generator=g)
    m0, m1 = torch.rand(B, N, generator=g) > 0.2, torch.rand(
        B, M, generator=g) > 0.2
    c0, c1 = torch.randn(B, h, N, d, generator=g), torch.randn(
        B, h, M, d, generator=g)

    def grads(dev):
        xs = [t.to(dev).requires_grad_() for t in (qk0, qk1, v0, v1)]
        a, b, va, vb = xs
        o0 = ak.fused_attention(a, b, vb, m1.to(dev), 1.0)
        o1 = ak.fused_attention(b, a, va, m0.to(dev), 1.0)
        loss = (o0 * c0.to(dev)).sum() + (o1 * c1.to(dev)).sum()
        return [t.cpu() for t in torch.autograd.grad(loss, xs)]

    before = (ak.attention_fwd.launches, ak.attention_bwd.launches)
    got = grads("cuda")
    assert (ak.attention_fwd.launches, ak.attention_bwd.launches) == (
        before[0] + 2, before[1] + 2)
    for a, b in zip(got, grads("cpu")):
        assert (a - b).abs().max() <= 1e-4 * max(1.0, float(b.abs().max()))


def test_kernels_refuse_what_they_do_not_take(cuda):
    q = torch.zeros(1, 1, 8, 32, device="cuda")
    with pytest.raises(ValueError):
        ak.self_attention(q, q, q, rot=(q[:, 0], q[:, 0]))
    with pytest.raises(TypeError):
        nk.nms_rounds(torch.zeros(1, 8, 8, device="cuda",
                                  dtype=torch.float16), 2)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("block_q", [64, 128])
@pytest.mark.parametrize("rot", [False, True])
def test_qblock_attention_kernel(cuda, dtype, tol, block_q, rot):
    """Kernel E at ragged N != M (rot-free) or N == M = 200 (rot), strided
    operands, against its plain version."""
    B, h, d = 2, 3, 64
    N, M = (200, 200) if rot else (200, 136)
    q = _strided_heads(cuda, B, N, h, d, dtype)
    k = _strided_heads(cuda, B, M, h, d, dtype, 1)
    v = _strided_heads(cuda, B, M, h, d, dtype, 2)
    table = None
    if rot:
        ang = torch.rand(B, N, d // 2, generator=cuda, device="cuda") * 6.28
        table = tuple(torch.repeat_interleave(f(ang), 2, -1).to(dtype)
                      for f in (torch.cos, torch.sin))
    mask = torch.rand(B, M, generator=cuda, device="cuda") > 0.2
    bias = ak.key_bias(mask, B, M, "cuda")
    before = ak.qblock_attention.launches
    got = ak.qblock_attention(q, k, v, bias, 0.125, block_q, table)
    assert ak.qblock_attention.launches == before + 1
    want = ak.qblock_attention_plain(q, k, v, bias, 0.125, table)
    bound = tol * max(1.0, float(want.float().abs().max()))
    assert (got.float() - want.float()).abs().max() <= bound


def test_qblock_dispatch_and_refusals(cuda):
    """block_q dividing N takes E (cross: two launches); otherwise A and B;
    self-attention without rot takes D's forward; other tile sizes raise."""
    B, h, N, d = 1, 2, 128, 64
    q, k, v = (torch.randn(B, h, N, d, generator=cuda, device="cuda")
               for _ in range(3))
    counts = lambda: (ak.self_attention.launches, ak.qblock_attention.launches,
                      ak.attention_fwd.launches,
                      ak.cross_attention_bidir.launches)
    c0 = counts()
    ak.self_attention(q, k, v, block_q=64)
    ak.cross_attention_bidir(q, k, q, v, block_q=64)
    ak.self_attention(q, k, v)                    # rot-free, whole rows: D
    ak.self_attention(q, k, v, block_q=96)        # 96 does not divide 128
    c1 = counts()
    assert tuple(b - a for a, b in zip(c0, c1)) == (0, 3, 2, 0)
    with pytest.raises(ValueError):
        ak.self_attention(q, k, v, block_q=32)    # divides N, not compiled
    bias = ak.key_bias(None, B, N, "cuda")
    with pytest.raises(ValueError):
        ak.qblock_attention(q, k[:, :, :64], v[:, :, :64], bias[:, :64], 1.0,
                            64, rot=(q[:, 0], q[:, 0]))   # rot needs N == M


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("N,M", [(200, 136), (128, 384)])
def test_flash_segment_kernel(cuda, dtype, tol, N, M):
    """Kernel G at ragged N != M, strided operands and general segment ids
    (one batch row fully masked), against its plain version, and the same
    bits on a second call."""
    from ei_nexus_tpu_torch.ops import flash_kernel as fk
    B, h, d = 3, 2, 64
    q = _strided_heads(cuda, B, N, h, d, dtype)
    k = _strided_heads(cuda, B, M, h, d, dtype, 1)
    v = _strided_heads(cuda, B, M, h, d, dtype, 2)
    q_seg = torch.randint(0, 3, (B, N), generator=cuda, device="cuda",
                          dtype=torch.int32)
    kv_seg = torch.randint(0, 3, (B, M), generator=cuda, device="cuda",
                           dtype=torch.int32)
    kv_seg[2] = 7                                 # no query shares it
    before = fk.flash_attention.launches
    got = fk.flash_attention(q, k, v, q_seg, kv_seg, 0.125)
    assert fk.flash_attention.launches == before + 1
    want = fk.flash_attention_plain(q, k, v, q_seg, kv_seg, 0.125)
    bound = tol * max(1.0, float(want.float().abs().max()))
    assert torch.isfinite(got.float()).all()
    assert (got.float() - want.float()).abs().max() <= bound
    assert torch.equal(fk.flash_attention(q, k, v, q_seg, kv_seg, 0.125), got)
    # without ids: no mask
    got = fk.flash_attention(q, k, v, sm_scale=1.0)
    want = fk.flash_attention_plain(q, k, v, sm_scale=1.0)
    bound = tol * max(1.0, float(want.float().abs().max()))
    assert (got.float() - want.float()).abs().max() <= bound


def test_pose_on_the_card_matches_the_cpu(cuda):
    """estimate_pose_batch with injected indices, on the card and on the
    CPU. In float64 the two agree (R, t to 1e-4, n_inliers +-1): the card's
    QR returns another nullspace basis, so the candidates come in another
    order, but the same set. In float32 an ill-conditioned minimal sample's
    candidates move under rounding alone, so there both are held to the
    truth (< 1 degree)."""
    import numpy as np
    from ei_nexus_tpu_torch.metrics import ransac as tr
    rng = np.random.default_rng(0)
    B, N = 3, 512
    p0 = np.zeros((B, N, 2))
    p1 = np.zeros((B, N, 2))
    mask = np.zeros((B, N), bool)
    truth = []
    for b, n in enumerate((300, 200, 0)):
        if n:
            P = rng.uniform(-1.5, 1.5, (n, 3)) + [0, 0, 4.0]
            R = _rotation(rng.normal(size=3) * 0.1)
            t = rng.normal(size=3)
            t /= np.linalg.norm(t)
            Q = P @ R.T + t
            p0[b, :n] = P[:, :2] / P[:, 2:] + rng.normal(0, 5e-4, (n, 2))
            p1[b, :n] = Q[:, :2] / Q[:, 2:] + rng.normal(0, 5e-4, (n, 2))
            mask[b, :n] = True
            truth.append(R)
    gen = torch.Generator().manual_seed(0)
    indices = tr.sample_indices(torch.from_numpy(mask), 128, "5pt", gen)
    for dtype in (torch.float64, torch.float32):
        args = [torch.from_numpy(a) for a in (p0, p1)]
        args = [a.to(dtype) for a in args] + [
            torch.from_numpy(mask), torch.full((B,), 5e-3, dtype=dtype)]
        R_c, t_c, _, n_c = tr.estimate_pose_batch(*args, indices=indices)
        dev = tr.estimate_pose_batch(*(a.cuda() for a in args),
                                     indices=tuple(i.cuda() for i in indices))
        assert all(x.device.type == "cuda" for x in dev)
        R_g, t_g, _, n_g = (x.cpu() for x in dev)
        assert n_g[2] == n_c[2] == 0
        if dtype == torch.float64:
            assert (n_c - n_g).abs().max() <= 1
            assert (R_c[:2] - R_g[:2]).abs().max() <= 1e-4
            assert (t_c[:2] - t_g[:2]).abs().max() <= 1e-4
        for b in range(2):
            for R in (R_c[b], R_g[b]):
                c = (np.trace(R.double().numpy().T @ truth[b]) - 1) / 2
                assert np.degrees(np.arccos(np.clip(c, -1, 1))) < 1.0


def _rotation(w):
    """Rodrigues' rotation of the axis-angle vector w (numpy)."""
    import numpy as np
    th = np.linalg.norm(w)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K
