"""The port's CUDA kernels against their plain versions on the card (marked
`cuda`; they skip on a host without one; `python3 chip_smoke.py` holds the
same kernels at the main path's shapes).

Run on the card: python -m pytest tests/test_torch_cuda.py -q -m cuda
(add --noconftest where JAX is not installed: tests/conftest.py imports it)

Tolerances: float32 atol 1e-4 (the kernels' float32 sums run in another
order and their softmax is online); bfloat16 atol 2e-2 (the kernels round
the unnormalised probabilities to bfloat16, the plain version the
normalised ones), times max(1, max|ref|) for E and G and the Hopper loop
of A and E (bf16: `hopper_attention`, with its pack pass); NMS bit-exact. The
pose tail on the card is held to the CPU in float64 (R, t to 1e-4). The backward (kernel F) is held to
1e-4 * max(1, max|ref|) in float32 and 2e-2 * max(1, max|ref|) in bfloat16:
it takes c = rowsum(dP o P) in float32 as the plain version does (summed
in another order), and its P = exp(s - m) / l uses the forward's row max
and row sum; no atomics, so it repeats exactly from run to run. A typical
gradient entry is far below 1, so each gradient is also held to a
relative norm, ||got - want|| / ||want|| <= 1e-4 (float32) or 1e-2
(bfloat16, whose rounding of the outputs alone gives ~2e-3), also on the
inputs where dP - c cancels (`tests/torch_bwd_cases.py`: collapsed value
rows, one-hot softmax rows), where c = rowsum(dO o O) from an output
rounded to bfloat16 departs by 0.4 or more; planted faults of F's inputs
(the neighbouring row's statistics, the row sum doubled, the neighbouring
batch row's key bias) move it by 5e-2 or more. A batch row whose keys are
all masked is in the D, F and B cases: its softmax is uniform, 1/M a key.
"""

import math
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from ei_nexus_tpu_torch.ops import attention_kernels as ak
from ei_nexus_tpu_torch.ops import cuda_build
from ei_nexus_tpu_torch.ops import nms_kernel as nk
# tests/ itself, as pytest puts it on sys.path: on the card's machine an
# installed package named `tests` shadows this directory's
from torch_bwd_cases import bwd_case  # noqa: E402

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
                                                 ((24, 264, 352), 4, 4),
                                                 ((2, 7, 9), 4, 4)])
def test_nms_kernel_bit_exact(cuda, shape, radius, n_iter):
    """Bit-exact against the plain version; (24, 264, 352) is more clusters
    than fit on the card at once; (2, 7, 9) holds one row a block, fewer
    than the radius, so the column windows read further ranks."""
    s = torch.rand(*shape, generator=cuda, device="cuda")
    s = torch.where(s > 0.4, s, torch.zeros_like(s))
    before = nk.nms_rounds.launches
    assert torch.equal(nk.nms_rounds(s, radius, n_iter),
                       nk.nms_rounds_plain(s, radius, n_iter))
    assert nk.nms_rounds.launches == before + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("radius", range(1, nk.MAX_RADIUS + 1))
def test_nms_kernel_every_radius(cuda, radius, dtype):
    """Every radius the kernel is compiled for (both register tunings, all
    four doubling depths), bit-exact in float32 and bfloat16 on a map of
    one cluster and on one the plan cuts into tiles."""
    for shape in ((2, 70, 90), (1, 700, 900)):
        s = torch.rand(*shape, generator=cuda, device="cuda")
        s = torch.where(s > 0.4, s, torch.zeros_like(s)).to(dtype)
        assert torch.equal(nk.nms_rounds(s, radius, 3),
                           nk.nms_rounds_plain(s, radius, 3))
    assert len(nk.nms_plan(1, 700, 900, radius, 3, s.element_size())
               .row_strips) > 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_nms_kernel_plateau_ties(cuda, dtype):
    """Scores rounded to multiples of 1/8, so neighbouring positive peaks
    tie, at the flagship's shape."""
    s = torch.rand(8, 264, 352, generator=cuda, device="cuda")
    s = torch.round(s * 8) / 8
    s = torch.where(s >= 0.3, s, torch.zeros_like(s)).to(dtype)
    assert torch.equal(nk.nms_rounds(s, 4, 4), nk.nms_rounds_plain(s, 4, 4))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 1024, 1280), (1, 512, 3840),
                                   (1, 16, 20000), (1, 4096, 200),
                                   (2, 500, 1001)])
def test_nms_kernel_strips(cuda, dtype, shape):
    """Maps one cluster cannot hold: the plan cuts them into tiles, row
    strips and, where the rows are too wide, column strips, that load
    2 * n_iter * r ghost rows and columns each side; bit-exact all the
    same. (2, 500, 1001) has no 16-byte column boundaries."""
    es = torch.empty((), dtype=dtype).element_size()
    plan = nk.nms_plan(*shape, 4, 4, es)
    assert len(plan.row_strips) * len(plan.col_strips) > 1
    # the plan's shared memory is the kernel's
    lib = cuda_build.library("nms")
    assert lib.ei_nms_smem_bytes(plan.rows, plan.width, es,
                                 4) == plan.smem_bytes
    s = torch.rand(*shape, generator=cuda, device="cuda")
    s = torch.where(s > 0.4, s, torch.zeros_like(s)).to(dtype)
    assert torch.equal(nk.nms_rounds(s, 4, 4), nk.nms_rounds_plain(s, 4, 4))


def test_nms_plan_refuses_before_launch(cuda):
    """What the plan refuses raises ValueError on the card, and nothing is
    launched: a radius the kernel is not compiled for, tiles that would own
    nothing beyond their ghost rows and columns."""
    before = nk.nms_rounds.launches
    s = torch.rand(1, 64, 64, generator=cuda, device="cuda")
    with pytest.raises(ValueError):
        nk.nms_rounds(s, nk.MAX_RADIUS + 1)
    with pytest.raises(ValueError):
        nk.nms_rounds(torch.zeros(1, 600, 600, device="cuda"), 8, 14)
    assert nk.nms_rounds.launches == before


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
    out, stats, _ = ak.attention_fwd(q, k, v, bias, scale)
    assert ak.attention_fwd.launches == before + 1
    want = ak.fused_attention_plain(q, k, v, mask, scale)
    s = torch.matmul(q.float(), k.float().mT) * scale + bias[:, None, None]
    assert (out.float() - want.float()).abs().max() <= tol
    # the row max and the row sum of exp(s - m), up to the product's order
    m = s.amax(-1)
    assert (stats[0] - m).abs().max() <= 1e-4 * max(1.0,
                                                    float(m.abs().max()))
    l = torch.exp(s - m[..., None]).sum(-1)
    assert ((stats[1] - l).abs() <= 1e-4 * l).all()


def _in_wqkv_slab(t: torch.Tensor, which: int) -> torch.Tensor:
    """The (B, h, n, d) values of `t` as the stride-3 view (phase `which`)
    of a (B, n, h, d, 3) buffer, as SelfBlock's Wqkv split lays them out."""
    B, h, n, d = t.shape
    buf = torch.zeros(B, n, h, d, 3, dtype=t.dtype, device=t.device)
    buf[..., which] = t.transpose(1, 2)
    return buf.transpose(1, 2)[..., which]


def _bwd_operands(cuda, values, B, h, N, M, d, dtype):
    """F's (q, k, v, do, mask) on the card, q, k, v stride-3 views (packed
    first in bfloat16): "normal" random values with the last batch row's
    keys all masked, or a case of `tests/torch_bwd_cases.py` (dP - c
    cancels), made with numpy from seed 0; or as the stage-2 step hands
    them: "self" the stride-3 views, "cross" the head views of (B, n, h,
    d) projections, q and k pre-scaled by d^-0.25 (read in place), each
    with dO the (B, h, N, d) view of a (B, N, h, d) buffer that autograd
    hands over and the last batch row's keys all masked."""
    if values in ("self", "cross"):
        if values == "self":
            q, k, v = (_strided_heads(cuda, B, n, h, d, dtype, i)
                       for i, n in enumerate((N, M, M)))
        else:
            q, k, v = (
                (torch.randn(B, n, h, d, generator=cuda, device="cuda")
                 * s).to(dtype).transpose(1, 2)
                for n, s in ((N, d ** -0.25), (M, d ** -0.25), (M, 1.0)))
        mask = torch.rand(B, M, generator=cuda, device="cuda") > 0.2
        mask[-1] = False
        do = torch.randn(B, N, h, d, generator=cuda, device="cuda").to(
            dtype).permute(0, 2, 1, 3)
        return q, k, v, do, mask
    if values == "normal":
        q = _strided_heads(cuda, B, N, h, d, dtype)
        k = _strided_heads(cuda, B, M, h, d, dtype, 1)
        v = _strided_heads(cuda, B, M, h, d, dtype, 2)
        mask = torch.rand(B, M, generator=cuda, device="cuda") > 0.2
        mask[-1] = False
        do = torch.randn(B, h, N, d, generator=cuda, device="cuda").to(dtype)
        return q, k, v, do, mask
    q, k, v, do, mask = (torch.from_numpy(a).cuda()
                         for a in bwd_case(values, B, h, N, M, d))
    q, k, v = (_in_wqkv_slab(t.to(dtype), i) for i, t in enumerate((q, k, v)))
    return q, k, v, do.to(dtype), mask


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,h,N,M,scale,values", [
    (3, 2, 200, 136, 0.125, "normal"), (3, 2, 128, 256, 1.0, "normal"),
    (2, 4, 1024, 1024, 0.125, "collapsed"),
    (2, 4, 1024, 1024, 0.125, "one-hot"),
    (8, 4, 1024, 1024, 0.125, "self"), (8, 4, 1024, 1024, 1.0, "cross")])
def test_attention_bwd_kernel(cuda, dtype, tol, B, h, N, M, scale, values):
    """F on stride-3 operands (packed first: bfloat16 by the operand plan,
    float32 always, into its 3xTF32 planes): at ragged N != M
    with random values, the last batch row's keys all masked; on the
    (2, 4, 1024, 64) inputs where dP - c cancels (collapsed value rows,
    one-hot softmax rows), where c taken from the rounded output fails;
    and at the stage-2 step's (8, 4, 1024, 64), self (stride-3 views) and
    cross (head views read in place, scale 1). Each gradient against the
    plain version, and the last batch row's alone too."""
    d = 64
    q, k, v, do, mask = _bwd_operands(cuda, values, B, h, N, M, d, dtype)
    bias = ak.key_bias(mask, B, M, "cuda")
    _, stats, _ = ak.attention_fwd(q, k, v, bias, scale)
    before = ak.attention_bwd.launches
    packs = ak.hopper_attention.packs
    got = ak.attention_bwd(q, k, v, do, bias, stats, scale)
    assert ak.attention_bwd.launches == before + 1
    # bf16: the stride-3 views are packed; float32: F's planes, always
    assert ak.hopper_attention.packs == packs + (
        dtype == torch.float32 or values != "cross")
    want = ak.fused_attention_bwd_plain(q, k, v, bias, do, scale)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        for rows in (slice(None), slice(-1, None)):
            a_, b_ = a[rows], b[rows]
            bound = tol * max(1.0, float(b_.float().abs().max()))
            assert (a_.float() - b_.float()).abs().max() <= bound, name
            assert _rel(a_, b_) <= BWD_REL[dtype], (name, _rel(a_, b_))
    # the same inputs give the same bits: no atomics in the sums
    again = ak.attention_bwd(q, k, v, do, bias, stats, scale)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def _bwd_faults(bias: torch.Tensor, stats: torch.Tensor):
    """Planted faults of F's inputs: (name, bias, stats) with the
    neighbouring query row's statistics, the row sum l doubled, or the
    neighbouring batch row's key bias."""
    doubled = stats.clone()
    doubled[1] *= 2
    return (("stats of the next row", bias, stats.roll(1, -1)),
            ("l doubled", bias, doubled),
            ("bias of the next batch row", bias.roll(1, 0), stats))


def _fault_gap(got, want) -> float:
    """The largest relative norm of a planted fault's gradients against
    the plain version's; NaN, which a live row's bias on a fully masked
    row's statistics gives and the check also catches, counts as inf."""
    rels = (_rel(a, w) for a, w in zip(got, want))
    return max(math.inf if math.isnan(r) else r for r in rels)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_bwd_check_catches_planted_faults(cuda, dtype):
    """The relative-norm check of test_attention_bwd_kernel fails when F
    reads the row statistics (max and sum) of the neighbouring row, a row
    sum doubled, or the neighbouring batch row's key bias, at the
    flagship's self-attention statistics (scale d^-0.5, ~80% of 1024 keys
    live)."""
    B, h, N, M, d = 2, 2, 1024, 1024, 64
    q = _strided_heads(cuda, B, N, h, d, dtype)
    k = _strided_heads(cuda, B, M, h, d, dtype, 1)
    v = _strided_heads(cuda, B, M, h, d, dtype, 2)
    mask = torch.rand(B, M, generator=cuda, device="cuda") > 0.2
    bias = ak.key_bias(mask, B, M, "cuda")
    _, stats, _ = ak.attention_fwd(q, k, v, bias, d ** -0.5)
    do = torch.randn(B, h, N, d, generator=cuda, device="cuda").to(dtype)
    want = ak.fused_attention_bwd_plain(q, k, v, bias, do, d ** -0.5)
    for fault, b, st in _bwd_faults(bias, stats):
        got = ak.attention_bwd(q, k, v, do, b, st, d ** -0.5)
        assert _fault_gap(got, want) > 5 * BWD_REL[dtype], fault


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


def test_fused_attention_backward_first_in_its_thread(cuda):
    """F as the first node of a process's first backward: autograd's
    device thread has made no CUDA runtime call yet, and F's tensor maps
    must still encode (cuTensorMapEncodeTiled needs the thread's current
    context). A process of its own, as the thread lives as long as the
    process."""
    code = textwrap.dedent("""
        import torch
        from ei_nexus_tpu_torch.ops import attention_kernels as ak
        q, k, v = (torch.randn(1, 2, 128, 64, device="cuda").to(
            torch.bfloat16).requires_grad_() for _ in range(3))
        out = ak.fused_attention(q, k, v)
        torch.autograd.grad(out, (q, k, v), torch.ones_like(out))
        torch.cuda.synchronize()
        print("launches", ak.attention_bwd.launches)
    """)
    run = subprocess.run([sys.executable, "-c", code],
                         cwd=Path(__file__).resolve().parent.parent,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    assert run.stdout.split()[-2:] == ["launches", "1"], run.stdout


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_fused_attention_masked_row_matches_cpu(cuda, dtype, tol):
    """D then F through autograd (`fused_attention`) with one batch row's
    keys all masked, on the card against the CPU's plain versions, the
    SelfBlock training layout (q, k head views, v the stride-3 view): the
    masked row's gradients are those of a uniform softmax (1/M a key), not
    M times them."""
    B, h, N, d = 2, 2, 200, 64
    g = torch.Generator().manual_seed(3)
    qkv = torch.randn(B, N, h * d * 3, generator=g).to(dtype)
    mask = torch.rand(B, N, generator=g) > 0.2
    mask[1] = False
    co = torch.randn(B, h, N, d, generator=g)

    def grads(dev):
        x = qkv.to(dev).requires_grad_()
        t = x.unflatten(-1, (h, d, 3)).transpose(1, 2)
        q, k = (t[..., i].transpose(1, 2).contiguous().transpose(1, 2)
                for i in range(2))
        out = ak.fused_attention(q, k, t[..., 2], mask.to(dev))
        (gx,) = torch.autograd.grad((out.float() * co.to(dev)).sum(), x)
        return gx.cpu().float()

    before = ak.attention_bwd.launches
    got = grads("cuda")
    assert ak.attention_bwd.launches == before + 1
    want = grads("cpu")
    for rows in (slice(None), slice(1, 2)):
        bound = tol * max(1.0, float(want[rows].abs().max()))
        assert (got[rows] - want[rows]).abs().max() <= bound
        assert _rel(got[rows], want[rows]) <= BWD_REL[dtype]


@pytest.mark.parametrize("N,M", [(200, 136), (64, 320)])
@pytest.mark.parametrize("masked", [0, 1])
def test_cross_attention_hopper_loop(cuda, N, M, masked):
    """The bf16 B on the Hopper loop, both directions in one launch, at
    N != M on CrossBlock's head views (read in place: no pack launch), one
    side's keys all masked in batch row 1; the same bits on a second call.
    Stride-3 views are packed first (one pack launch)."""
    B, h, d = 2, 3, 64

    def heads(n):
        x = torch.randn(B, n, h * d, generator=cuda, device="cuda")
        return x.to(torch.bfloat16).unflatten(-1, (h, d)).transpose(1, 2)
    qk0, qk1 = heads(N) * d ** -0.25, heads(M) * d ** -0.25
    v0, v1 = heads(N), heads(M)
    m0 = torch.rand(B, N, generator=cuda, device="cuda") > 0.2
    m1 = torch.rand(B, M, generator=cuda, device="cuda") > 0.2
    (m0, m1)[masked][1] = False
    before, packs = ak.cross_attention_bidir.launches, ak.hopper_attention.packs
    got = ak.cross_attention_bidir(qk0, qk1, v0, v1, m0, m1)
    assert ak.cross_attention_bidir.launches == before + 1
    assert ak.hopper_attention.packs == packs
    want = ak.cross_attention_bidir_plain(qk0, qk1, v0, v1, m0, m1)
    for a, b in zip(got, want):
        assert torch.isfinite(a.float()).all()
        assert _close(a, b)
    # the fully masked side's keys give the other side's queries a uniform
    # average of its values
    mean = (v0, v1)[masked][1].float().mean(dim=1, keepdim=True)
    other = got[1 - masked][1]
    assert _close(other, mean.expand_as(other))
    again = ak.cross_attention_bidir(qk0, qk1, v0, v1, m0, m1)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    # stride-3 views of one buffer per side: packed, then the same results
    s0 = _strided_heads(cuda, B, N, h, d, torch.bfloat16)
    s1 = _strided_heads(cuda, B, M, h, d, torch.bfloat16, 1)
    packs = ak.hopper_attention.packs
    got = ak.cross_attention_bidir(s0, s1, v0, v1, m0, m1)
    assert ak.hopper_attention.packs == packs + 1
    want = ak.cross_attention_bidir_plain(s0, s1, v0, v1, m0, m1)
    assert all(_close(a, b) for a, b in zip(got, want))


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


def _rot_tables(gen, B, n, d, dtype):
    ang = torch.rand(B, n, d // 2, generator=gen, device="cuda") * 6.28
    return tuple(torch.repeat_interleave(f(ang), 2, -1).to(dtype)
                 for f in (torch.cos, torch.sin))


def _wqkv_heads(gen, B, n, h, d, shared):
    """q, k, v as SelfBlock splits its Wqkv output: stride-3 views at
    phases 0, 1, 2 of one (B, n, h, d, 3) buffer, or of three."""
    if shared:
        x = torch.randn(B, n, h * d * 3, generator=gen, device="cuda")
        qkv = x.to(torch.bfloat16).unflatten(-1, (h, d, 3)).transpose(1, 2)
        return qkv[..., 0], qkv[..., 1], qkv[..., 2]
    return tuple(_strided_heads(gen, B, n, h, d, torch.bfloat16, i)
                 for i in range(3))


def _close(got, want, tol=2e-2):
    bound = tol * max(1.0, float(want.float().abs().max()))
    return float((got.float() - want.float()).abs().max()) <= bound


@pytest.mark.parametrize("kernel", ["A", "E64", "E128"])
@pytest.mark.parametrize("N", [200, 1000, 1024])
@pytest.mark.parametrize("shared", [False, True])
def test_hopper_loop_rotary(cuda, kernel, N, shared):
    """The bf16 Hopper loop of A and E (block_q 64, 128) with the rotary,
    on the Wqkv views (packed first: one pack launch a call), against the
    plain version, at ragged and whole tiles."""
    B, h, d = 2, 3, 64
    q, k, v = _wqkv_heads(cuda, B, N, h, d, shared)
    rot = _rot_tables(cuda, B, N, d, torch.bfloat16)
    mask = torch.rand(B, N, generator=cuda, device="cuda") > 0.2
    bias = ak.key_bias(mask, B, N, "cuda")
    packs = ak.hopper_attention.packs
    if kernel == "A":
        before = ak.self_attention.launches
        got = ak.self_attention(q, k, v, mask, rot=rot)
        assert ak.self_attention.launches == before + 1
    else:
        before = ak.qblock_attention.launches
        got = ak.qblock_attention(q, k, v, bias, d ** -0.5, int(kernel[1:]),
                                  rot)
        assert ak.qblock_attention.launches == before + 1
    assert ak.hopper_attention.packs == packs + 1
    want = ak.qblock_attention_plain(q, k, v, bias, d ** -0.5, rot)
    assert _close(got, want)


@pytest.mark.parametrize("block_q", [64, 128])
def test_hopper_loop_reads_head_views_in_place(cuda, block_q):
    """E rot-free at N != M on CrossBlock's unit-stride head views (pre-
    scaled, scale 1): read by TMA in place, no pack launch."""
    B, h, d, N, M = 2, 3, 64, 200, 136

    def heads(n):
        x = torch.randn(B, n, h * d, generator=cuda, device="cuda")
        return x.to(torch.bfloat16).unflatten(-1, (h, d)).transpose(1, 2)
    q, k, v = heads(N) * d ** -0.25, heads(M) * d ** -0.25, heads(M)
    assert {ak.operand_plan(t).mode for t in (q, k, v)} == {"direct"}
    mask = torch.rand(B, M, generator=cuda, device="cuda") > 0.2
    bias = ak.key_bias(mask, B, M, "cuda")
    packs = ak.hopper_attention.packs
    got = ak.qblock_attention(q, k, v, bias, 1.0, block_q)
    assert ak.hopper_attention.packs == packs
    assert _close(got, ak.qblock_attention_plain(q, k, v, bias, 1.0))


@pytest.mark.parametrize("kernel", ["A", "E64"])
def test_hopper_loop_masked_row_and_repeat(cuda, kernel):
    """A batch row whose keys are all masked gives the plain version's
    finite, uniform average of V; two calls give the same bits."""
    B, h, d, N = 2, 2, 64, 300
    q, k, v = _wqkv_heads(cuda, B, N, h, d, True)
    rot = _rot_tables(cuda, B, N, d, torch.bfloat16)
    mask = torch.rand(B, N, generator=cuda, device="cuda") > 0.2
    mask[1] = False
    bias = ak.key_bias(mask, B, N, "cuda")

    def run():
        if kernel == "A":
            return ak.self_attention(q, k, v, mask, rot=rot)
        return ak.qblock_attention(q, k, v, bias, d ** -0.5, 64, rot)
    got = run()
    assert torch.isfinite(got.float()).all()
    want = ak.qblock_attention_plain(q, k, v, bias, d ** -0.5, rot)
    assert _close(got, want)
    mean = v[1].float().mean(dim=1, keepdim=True).expand(-1, N, -1)
    assert _close(got[1], mean)
    assert torch.equal(run(), got)


def test_hopper_loop_packs_one_view_twice(cuda):
    """q and k the same Wqkv view (one slab, one phase, two operands): the
    pack pass writes both, and the result is the plain version's."""
    B, h, d, N = 2, 2, 64, 136
    q, _, v = _wqkv_heads(cuda, B, N, h, d, True)
    rot = _rot_tables(cuda, B, N, d, torch.bfloat16)
    bias = ak.key_bias(None, B, N, "cuda")
    got = ak.qblock_attention(q, q, v, bias, d ** -0.5, 128, rot)
    assert _close(got, ak.qblock_attention_plain(q, q, v, bias, d ** -0.5,
                                                 rot))


def test_hopper_loop_refuses_what_the_plan_refuses(cuda):
    """A d stride of 2 is neither TMA's nor the pack pass's: the wrappers
    raise before any launch, and take no other path."""
    B, h, d, N = 1, 2, 64, 128
    x = torch.randn(B, h, N, 2 * d, generator=cuda, device="cuda").to(
        torch.bfloat16)
    q = x[..., ::2]
    k = v = x[..., :d].contiguous()
    rot = _rot_tables(cuda, B, N, d, torch.bfloat16)
    bias = ak.key_bias(None, B, N, "cuda")
    counts = (ak.self_attention.launches, ak.qblock_attention.launches,
              ak.attention_fwd.launches, ak.hopper_attention.packs)
    with pytest.raises(ValueError):
        ak.self_attention(q, k, v, rot=rot)
    with pytest.raises(ValueError):
        ak.qblock_attention(q, k, v, bias, 0.125, 64)
    with pytest.raises(ValueError):
        ak.qblock_attention(k, q, v, bias, 0.125, 128, rot)
    assert (ak.self_attention.launches, ak.qblock_attention.launches,
            ak.attention_fwd.launches, ak.hopper_attention.packs) == counts


# ---------------------------------------------------------------------------
# kernels A and B in float32: the pack pass and the 3xTF32 loop
# ---------------------------------------------------------------------------


def _f32_heads(gen, B, n, h, d, scale=1.0):
    """(B, h, n, d) float32 head view of a (B, n, h * d) projection, as
    CrossBlock splits heads."""
    x = torch.randn(B, n, h * d, generator=gen, device="cuda") * scale
    return x.unflatten(-1, (h, d)).transpose(1, 2)


def _f32_wqkv(gen, B, n, h, d):
    """q, k, v: the stride-3 views of one float32 (B, n, h, d, 3) Wqkv
    output, as SelfBlock splits it."""
    x = torch.randn(B, n, h * d * 3, generator=gen, device="cuda")
    qkv = x.unflatten(-1, (h, d, 3)).transpose(1, 2)
    return qkv[..., 0], qkv[..., 1], qkv[..., 2]


@pytest.mark.parametrize("N", [64, 200, 1024])
def test_f32_self_attention_loop(cuda, N):
    """Float32 A on the 3xTF32 loop: the stride-3 Wqkv views, the last
    batch row's keys all masked (the uniform average of v), against the
    plain version to 1e-4 x max(1, max|ref|); one pack launch and one loop
    launch a call; the same bits on a second call."""
    B, h, d = 2, 3, 64
    q, k, v = _f32_wqkv(cuda, B, N, h, d)
    rot = _rot_tables(cuda, B, N, d, torch.float32)
    mask = torch.rand(B, N, generator=cuda, device="cuda") > 0.2
    mask[-1] = False
    before, packs = ak.self_attention.launches, ak.hopper_attention.packs
    got = ak.self_attention(q, k, v, mask, rot=rot)
    assert ak.self_attention.launches == before + 1
    assert ak.hopper_attention.packs == packs + 1
    want = ak.self_attention_plain(q, k, v, mask, rot=rot)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert _close(got, want, 1e-4)
    mean = v[-1].mean(dim=1, keepdim=True).expand(-1, N, -1)
    assert _close(got[-1], mean, 1e-4)
    assert torch.equal(ak.self_attention(q, k, v, mask, rot=rot), got)


@pytest.mark.parametrize("N,M", [(200, 136), (64, 320), (1024, 1024)])
@pytest.mark.parametrize("masked", [0, 1])
def test_f32_cross_attention_loop(cuda, N, M, masked):
    """Float32 B on the 3xTF32 loop, both directions in one launch, at
    N != M on CrossBlock's head views, one side's keys all masked in batch
    row 1; against the plain version to 1e-4 x max(1, max|ref|), one pack
    launch and one loop launch, the same bits on a second call; stride-3
    views give the same results."""
    B, h, d = 2, 3, 64
    qk0 = _f32_heads(cuda, B, N, h, d, d ** -0.25)
    qk1 = _f32_heads(cuda, B, M, h, d, d ** -0.25)
    v0, v1 = _f32_heads(cuda, B, N, h, d), _f32_heads(cuda, B, M, h, d)
    m0 = torch.rand(B, N, generator=cuda, device="cuda") > 0.2
    m1 = torch.rand(B, M, generator=cuda, device="cuda") > 0.2
    (m0, m1)[masked][1] = False
    before, packs = ak.cross_attention_bidir.launches, ak.hopper_attention.packs
    got = ak.cross_attention_bidir(qk0, qk1, v0, v1, m0, m1)
    assert ak.cross_attention_bidir.launches == before + 1
    assert ak.hopper_attention.packs == packs + 1
    want = ak.cross_attention_bidir_plain(qk0, qk1, v0, v1, m0, m1)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and torch.isfinite(a).all()
        assert _close(a, b, 1e-4)
    mean = (v0, v1)[masked][1].mean(dim=1, keepdim=True)
    other = got[1 - masked][1]
    assert _close(other, mean.expand_as(other), 1e-4)
    again = ak.cross_attention_bidir(qk0, qk1, v0, v1, m0, m1)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    s0, _, _ = _f32_wqkv(cuda, B, N, h, d)
    _, s1, _ = _f32_wqkv(cuda, B, M, h, d)
    got = ak.cross_attention_bidir(s0, s1, v0, v1, m0, m1)
    want = ak.cross_attention_bidir_plain(s0, s1, v0, v1, m0, m1)
    assert all(_close(a, b, 1e-4) for a, b in zip(got, want))


@pytest.mark.parametrize("kernel", ["self_attention", "cross_attention"])
@pytest.mark.parametrize("N,M", [(200, 136), (64, 320)])
def test_f32_pack_pass_bit_exact(cuda, kernel, N, M):
    """The float32 pack pass equals `pack_f32_plain` bit for bit: A's
    rotated stride-3 q and k and its v, B's head views of both sides
    (ragged N and M: V^T's zero-padded last tile, its permuted key
    order)."""
    B, h, d = 2, 3, 64
    if kernel == "self_attention":
        q, k, v = _f32_wqkv(cuda, B, N, h, d)
        rot = tuple(t.contiguous() for t in
                    _rot_tables(cuda, B, N, d, torch.float32))
        args = ((q, k), (v,), rot)
    else:
        sides = [(_f32_heads(cuda, B, n, h, d, d ** -0.25),
                  _f32_heads(cuda, B, n, h, d)) for n in (N, M)]
        args = ((sides[0][0], sides[1][0]), (sides[0][1], sides[1][1]),
                None)
    packs = ak.hopper_attention.packs
    got = ak.pack_f32(*args, kernel=kernel)
    assert ak.hopper_attention.packs == packs + 1
    want = ak.pack_f32_plain(*args)
    for a, b in zip(got[0] + got[1], want[0] + want[1]):
        assert a.shape == b.shape and torch.equal(a, b)


def test_f32_loop_refuses_before_launch(cuda):
    """What the float32 A and B cannot take raises before any launch: a
    head dim other than 64, rotary tables of another shape or type; no
    path falls back to another kernel or the plain version."""
    B, h, N, d = 1, 2, 128, 64
    q, k, v = _f32_wqkv(cuda, B, N, h, d)
    rot = _rot_tables(cuda, B, N, d, torch.float32)
    counts = lambda: (ak.self_attention.launches,  # noqa: E731
                      ak.cross_attention_bidir.launches,
                      ak.attention_fwd.launches, ak.hopper_attention.packs)
    before = counts()
    with pytest.raises(ValueError):
        ak.self_attention(q, k, v, rot=(rot[0][:, :64], rot[1][:, :64]))
    with pytest.raises(ValueError):
        ak.self_attention(q, k, v, rot=tuple(t.double() for t in rot))
    x = torch.zeros(B, h, N, 32, device="cuda")
    with pytest.raises(ValueError):
        ak.cross_attention_bidir(x, x, x, x)
    assert counts() == before


# ---------------------------------------------------------------------------
# float32 D and F on the 3xTF32 loop
# ---------------------------------------------------------------------------


def _f32_fused(gen, B, h, N, M, d, layout):
    """Float32 D/F operands as the training blocks hand them: "self" q, k
    the rotated (contiguous (B, n, h, d) buffers seen as head views) and v
    the stride-3 view of a Wqkv output, scale d^-0.5; "cross" pre-scaled
    head views, scale 1; the last batch row's keys all masked, dO the
    (B, h, N, d) view of a (B, N, h, d) buffer."""
    if layout == "self":
        q = _f32_heads(gen, B, N, h, d)
        k = _f32_heads(gen, B, M, h, d)
        v = _f32_wqkv(gen, B, M, h, d)[2]
        scale = d ** -0.5
    else:
        q = _f32_heads(gen, B, N, h, d, d ** -0.25)
        k = _f32_heads(gen, B, M, h, d, d ** -0.25)
        v = _f32_heads(gen, B, M, h, d)
        scale = 1.0
    mask = torch.rand(B, M, generator=gen, device="cuda") > 0.2
    mask[-1] = False
    do = torch.randn(B, N, h, d, generator=gen, device="cuda").permute(
        0, 2, 1, 3)
    return q, k, v, do, ak.key_bias(mask, B, M, "cuda"), scale


@pytest.mark.parametrize("N,M", [(1024, 1024), (200, 136), (64, 1000)])
@pytest.mark.parametrize("layout", ["self", "cross"])
def test_f32_attention_fwd_loop(cuda, N, M, layout):
    """Float32 D on the 3xTF32 loop: one pack launch and one loop launch a
    call, v handed back as given (F packs its own planes); against the
    plain version to 1e-4 x max(1, max|ref|); m and l to relative 1e-5 (m
    against max(1, |m|)); the fully masked batch row's m = -1e9 and l = M
    exactly (a uniform softmax); the same bits on a second call."""
    B, h, d = 2, 3, 64
    q, k, v, _, bias, scale = _f32_fused(cuda, B, h, N, M, d, layout)
    before, packs = ak.attention_fwd.launches, ak.hopper_attention.packs
    out, stats, v_read = ak.attention_fwd(q, k, v, bias, scale)
    assert ak.attention_fwd.launches == before + 1
    assert ak.hopper_attention.packs == packs + 1
    assert v_read is v
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    assert _close(out, ak.fused_attention_plain(q, k, v, bias == 0, scale),
                  1e-4)
    s = torch.matmul(q, k.mT) * scale + bias[:, None, None]
    m = s.amax(-1)
    l = torch.exp(s - m[..., None]).sum(-1)
    assert ((stats[0] - m).abs() <= 1e-5 * m.abs().clamp(min=1.0)).all()
    assert ((stats[1] - l).abs() <= 1e-5 * l).all()
    assert (stats[0][-1] == -1e9).all() and (stats[1][-1] == M).all()
    again = ak.attention_fwd(q, k, v, bias, scale)
    assert torch.equal(again[0], out) and torch.equal(again[1], stats)


@pytest.mark.parametrize("N,M", [(200, 136), (64, 320)])
def test_f32_fused_pack_pass_bit_exact(cuda, N, M):
    """The pack launches of float32 D (q, k rows; v transposed) and F (q,
    k, v, dO rows; q, k, dO transposed: seven operands in one launch) equal
    `pack_f32_plain` bit for bit, from the training layouts' strides
    (ragged N and M: the transposed planes' zero-padded last tile and
    permuted order along the tokens)."""
    B, h, d = 2, 3, 64
    q, k, v, do, _, _ = _f32_fused(cuda, B, h, N, M, d, "self")
    for kernel, args in (("attention_fwd", ((q, k), (v,))),
                         ("attention_bwd", ((q, k, v, do), (q, k, do)))):
        packs = ak.hopper_attention.packs
        got = ak.pack_f32(*args, kernel=kernel)
        assert ak.hopper_attention.packs == packs + 1
        want = ak.pack_f32_plain(*args)
        for a, b in zip(got[0] + got[1], want[0] + want[1]):
            assert a.shape == b.shape and torch.equal(a, b), kernel


@pytest.mark.parametrize("N,M", [(1024, 1024), (200, 136)])
@pytest.mark.parametrize("layout", ["self", "cross"])
def test_f32_attention_bwd_loop(cuda, N, M, layout):
    """Float32 F on the 3xTF32 loop after float32 D: one pack launch (its
    seven operands) and one F launch a call; dq, dk, dv against the plain
    version to 1e-4 x max(1, max|ref|) and a relative norm of 1e-4, the
    fully masked batch row alone too; the same bits on a second call; each
    block kind alone (`blocks` 1: dK/dV, 2: dQ) gives its gradients' bits
    of the whole call."""
    B, h, d = 2, 3, 64
    q, k, v, do, bias, scale = _f32_fused(cuda, B, h, N, M, d, layout)
    _, stats, v_read = ak.attention_fwd(q, k, v, bias, scale)
    before, packs = ak.attention_bwd.launches, ak.hopper_attention.packs
    got = ak.attention_bwd(q, k, v_read, do, bias, stats, scale)
    assert ak.attention_bwd.launches == before + 1
    assert ak.hopper_attention.packs == packs + 1
    want = ak.fused_attention_bwd_plain(q, k, v, bias, do, scale)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        for rows in (slice(None), slice(-1, None)):
            assert _close(a[rows], b[rows], 1e-4), name
            assert _rel(a[rows], b[rows]) <= BWD_REL[torch.float32], name
    again = ak.attention_bwd(q, k, v_read, do, bias, stats, scale)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    _, dk, dv = ak.attention_bwd(q, k, v_read, do, bias, stats, scale,
                                 blocks=1)
    dq, _, _ = ak.attention_bwd(q, k, v_read, do, bias, stats, scale,
                                blocks=2)
    assert torch.equal(dq, got[0]) and torch.equal(dk, got[1]) \
        and torch.equal(dv, got[2])


def test_f32_fused_refuses_before_launch(cuda):
    """What float32 D and F cannot take raises before any pack or loop
    launch: a head dim other than 64, mismatched shapes, a bias or stats
    of another shape or type, a block mask other than 1, 2, 3; nothing
    falls back to another kernel or the plain version."""
    B, h, N, d = 1, 2, 128, 64
    q, k, v, do, bias, scale = _f32_fused(cuda, B, h, N, N, d, "self")
    _, stats, _ = ak.attention_fwd(q, k, v, bias, scale)
    counts = lambda: (ak.attention_fwd.launches,  # noqa: E731
                      ak.attention_bwd.launches, ak.hopper_attention.packs)
    before = counts()
    x = torch.zeros(B, h, N, 32, device="cuda")
    with pytest.raises(ValueError):
        ak.attention_fwd(x, x, x, bias, scale)
    with pytest.raises(ValueError):
        ak.attention_fwd(q, k[:, :, :64], v, bias, scale)
    with pytest.raises(ValueError):
        ak.attention_fwd(q, k, v, bias.double(), scale)
    with pytest.raises(ValueError):
        ak.attention_bwd(q, k, v, do, bias, stats[:, :, :, :64], scale)
    with pytest.raises(ValueError):
        ak.attention_bwd(q, k, v, do[..., :32], bias, stats, scale)
    with pytest.raises(ValueError):
        ak.attention_bwd(q, k, v, do, bias, stats, scale, blocks=0)
    assert counts() == before


# ---------------------------------------------------------------------------
# float32 E and G on the 3xTF32 loop
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case,N,M", [("rot", 200, 200), ("rot", 1024, 1024),
                                      ("rot-free", 200, 136),
                                      ("rot-free", 64, 320),
                                      ("rot-free", 1024, 1024)])
def test_f32_qblock_attention_loop(cuda, case, N, M):
    """Float32 E on the 3xTF32 loop: rot (SelfBlock's stride-3 Wqkv views,
    the pack pass rotating q and k, scale d^-0.5) or rot-free (CrossBlock's
    pre-scaled head views, N != M, scale 1), the last batch row's keys all
    masked (the mean of v); at block_q 64 and 128 each against the plain
    version to 1e-4 x max(1, max|ref|), one pack launch and one loop launch
    a call, the two block_q bit-equal (both run 64-row blocks) and the same
    bits on a second call."""
    B, h, d = 2, 3, 64
    if case == "rot":
        q, k, v = _f32_wqkv(cuda, B, N, h, d)
        rot = _rot_tables(cuda, B, N, d, torch.float32)
        scale = d ** -0.5
    else:
        q = _f32_heads(cuda, B, N, h, d, d ** -0.25)
        k = _f32_heads(cuda, B, M, h, d, d ** -0.25)
        v = _f32_heads(cuda, B, M, h, d)
        rot, scale = None, 1.0
    mask = torch.rand(B, M, generator=cuda, device="cuda") > 0.2
    mask[-1] = False
    bias = ak.key_bias(mask, B, M, "cuda")
    want = ak.qblock_attention_plain(q, k, v, bias, scale, rot)
    got = {}
    for block_q in (64, 128):
        before, packs = ak.qblock_attention.launches, ak.hopper_attention.packs
        got[block_q] = ak.qblock_attention(q, k, v, bias, scale, block_q, rot)
        assert ak.qblock_attention.launches == before + 1
        assert ak.hopper_attention.packs == packs + 1
        out = got[block_q]
        assert out.dtype == torch.float32 and torch.isfinite(out).all()
        assert _close(out, want, 1e-4)
        mean = v[-1].mean(dim=1, keepdim=True).expand(-1, N, -1)
        assert _close(out[-1], mean, 1e-4)
    assert torch.equal(got[64], got[128])
    assert torch.equal(ak.qblock_attention(q, k, v, bias, scale, 64, rot),
                       got[64])


@pytest.mark.parametrize("N,M", [(1024, 1024), (2048, 2048), (200, 136)])
def test_f32_flash_segment_loop(cuda, N, M):
    """Float32 G on the 3xTF32 loop in its segment mode, as the "flash"
    self-attention hands it its operands (q, k rotated, v the stride-3
    view): random query and key ids; batch row 1's keys in a segment no
    query has (every row the mean of V), batch row 0's first 64 keys too
    (a first tile wholly masked before valid keys); against the plain
    version to 1e-4 x max(1, max|ref|), finite, one pack launch and one
    loop launch a call, the same bits on a second call; without ids, no
    mask."""
    from ei_nexus_tpu_torch.ops import flash_kernel as fk
    B, h, d = 3, 2, 64
    q, _, _ = _f32_wqkv(cuda, B, N, h, d)
    _, k, v = _f32_wqkv(cuda, B, M, h, d)

    def rotated(t, n):
        cos, sin = (x[:, None] for x in _rot_tables(cuda, B, n, d,
                                                    torch.float32))
        return t * cos + ak.rotate_half(t) * sin
    q, k = rotated(q, N), rotated(k, M)
    q_seg = torch.randint(0, 3, (B, N), generator=cuda, device="cuda",
                          dtype=torch.int32)
    kv_seg = torch.randint(0, 3, (B, M), generator=cuda, device="cuda",
                           dtype=torch.int32)
    kv_seg[1] = -5
    kv_seg[0, :64] = 7
    before, packs = fk.flash_attention.launches, ak.hopper_attention.packs
    got = fk.flash_attention(q, k, v, q_seg, kv_seg, d ** -0.5)
    assert fk.flash_attention.launches == before + 1
    assert ak.hopper_attention.packs == packs + 1
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert _close(got, fk.flash_attention_plain(q, k, v, q_seg, kv_seg,
                                                d ** -0.5), 1e-4)
    mean = v[1].mean(dim=1, keepdim=True).expand(-1, N, -1)
    assert _close(got[1], mean, 1e-4)
    assert torch.equal(fk.flash_attention(q, k, v, q_seg, kv_seg,
                                          d ** -0.5), got)
    got = fk.flash_attention(q, k, v, sm_scale=1.0)
    assert _close(got, fk.flash_attention_plain(q, k, v, sm_scale=1.0), 1e-4)


def test_f32_e_and_g_refuse_before_launch(cuda):
    """What float32 E and G cannot take raises before the pack pass: a
    block_q other than 64 and 128, the rotary with N != M, segment ids of
    another type or shape; nothing falls back to another kernel or the
    plain version."""
    from ei_nexus_tpu_torch.ops import flash_kernel as fk
    B, h, N, d = 1, 2, 128, 64
    q, k, v = _f32_wqkv(cuda, B, N, h, d)
    bias = ak.key_bias(None, B, N, "cuda")
    rot = _rot_tables(cuda, B, N, d, torch.float32)
    ids = torch.ones(B, N, dtype=torch.int32, device="cuda")
    counts = lambda: (ak.qblock_attention.launches,  # noqa: E731
                      fk.flash_attention.launches, ak.hopper_attention.packs)
    before = counts()
    with pytest.raises(ValueError):
        ak.qblock_attention(q, k, v, bias, 1.0, 96)
    with pytest.raises(ValueError):
        ak.qblock_attention(q, k[:, :, :64], v[:, :, :64], bias[:, :64],
                            1.0, 64, rot=rot)
    with pytest.raises(ValueError):
        fk.flash_attention(q, k, v, ids.float(), ids)
    with pytest.raises(ValueError):
        fk.flash_attention(q, k, v, ids[:, :64], ids)
    assert counts() == before


# ---------------------------------------------------------------------------
# kernels D and G on the Hopper loop (bf16)
# ---------------------------------------------------------------------------


def _d_operands(gen, B, h, N, M, d, layout):
    """D's bf16 operands as the training blocks hand them: "self" the
    rotated q, k (contiguous (B, N, h, d) buffers seen as head views) and v
    the stride-3 view of a Wqkv output; "cross" pre-scaled head views."""
    if layout == "self":
        q = _strided_heads(gen, B, N, h, d, torch.bfloat16)
        q = q.transpose(1, 2).contiguous().transpose(1, 2)
        k = _strided_heads(gen, B, M, h, d, torch.bfloat16, 1)
        k = k.transpose(1, 2).contiguous().transpose(1, 2)
        return q, k, _strided_heads(gen, B, M, h, d, torch.bfloat16, 2)

    def heads(n, s):
        x = torch.randn(B, n, h * d, generator=gen, device="cuda")
        return x.to(torch.bfloat16).unflatten(-1, (h, d)).transpose(1, 2) * s
    return heads(N, d ** -0.25), heads(M, d ** -0.25), heads(M, 1.0)


@pytest.mark.parametrize("N,M", [(1024, 1024), (200, 136), (64, 1000)])
@pytest.mark.parametrize("layout", ["self", "cross"])
def test_attention_fwd_hopper_loop(cuda, N, M, layout):
    """D's bf16 instance (the Hopper loop with its statistics epilogue)
    against the plain version: scale d^-0.5 on the self layout (v the
    stride-3 view, packed: one pack launch, handed back contiguous), 1 on
    the cross layout (read in place); m and l to relative 1e-5 (m against
    max(1, |m|)); the last batch row's keys all masked, where m = -1e9 and
    l = M exactly (a uniform softmax)."""
    B, h, d = 2, 3, 64
    q, k, v = _d_operands(cuda, B, h, N, M, d, layout)
    scale = d ** -0.5 if layout == "self" else 1.0
    mask = torch.rand(B, M, generator=cuda, device="cuda") > 0.2
    mask[-1] = False
    bias = ak.key_bias(mask, B, M, "cuda")
    before, packs = ak.attention_fwd.launches, ak.hopper_attention.packs
    out, stats, v_read = ak.attention_fwd(q, k, v, bias, scale)
    assert ak.attention_fwd.launches == before + 1
    packed = layout == "self"
    assert ak.hopper_attention.packs == packs + packed
    if packed:
        assert v_read.is_contiguous() and torch.equal(v_read, v)
    else:
        assert v_read is v
    assert _close(out, ak.fused_attention_plain(q, k, v, mask, scale))
    s = torch.matmul(q.float(), k.float().mT) * scale + bias[:, None, None]
    m = s.amax(-1)
    l = torch.exp(s - m[..., None]).sum(-1)
    assert ((stats[0] - m).abs() <= 1e-5 * m.abs().clamp(min=1.0)).all()
    assert ((stats[1] - l).abs() <= 1e-5 * l).all()
    assert (stats[0][-1] == -1e9).all() and (stats[1][-1] == M).all()


def test_attention_fwd_hands_f_its_packed_v(cuda):
    """D then F with the v D packed: F reads it in place (no pack launch)
    and its gradients keep the relative-norm bound, which the three planted
    faults (the neighbouring row's statistics, the row sum doubled, the
    neighbouring batch row's bias) still break; the last batch row's keys
    all masked."""
    B, h, N, d = 2, 2, 1024, 64
    q, k, v = _d_operands(cuda, B, h, N, N, d, "self")
    mask = torch.rand(B, N, generator=cuda, device="cuda") > 0.2
    mask[-1] = False
    bias = ak.key_bias(mask, B, N, "cuda")
    scale = d ** -0.5
    _, stats, v_read = ak.attention_fwd(q, k, v, bias, scale)
    do = torch.randn(B, N, h, d, generator=cuda, device="cuda").to(
        torch.bfloat16).permute(0, 2, 1, 3)
    want = ak.fused_attention_bwd_plain(q, k, v, bias, do, scale)
    packs = ak.hopper_attention.packs
    got = ak.attention_bwd(q, k, v_read, do, bias, stats, scale)
    assert ak.hopper_attention.packs == packs
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        for rows in (slice(None), slice(-1, None)):
            assert _close(a[rows], b[rows]), name
            assert _rel(a[rows], b[rows]) <= BWD_REL[torch.bfloat16], name
    for fault, b_, st in _bwd_faults(bias, stats):
        bad = ak.attention_bwd(q, k, v_read, do, b_, st, scale)
        assert _fault_gap(bad, want) > 5 * BWD_REL[torch.bfloat16], fault


def test_selfblock_training_packs_once_a_call(cuda):
    """SelfBlock in training on the card (128 tokens, 4 heads of 64, bf16):
    one pack launch in the forward (D's v) and none in the backward (F
    reads D's packed v), one launch of D and one of F."""
    from ei_nexus_tpu_torch.models.lightglue import SelfBlock
    B, N, E, h = 2, 128, 256, 4
    g = torch.Generator().manual_seed(5)
    block = SelfBlock(E, h, dtype=torch.bfloat16, attn_impl="pallas").cuda()
    x = torch.randn(B, N, E, generator=g).to(torch.bfloat16).cuda()
    ang = torch.rand(B, 1, N, 32, generator=g) * 6.28
    enc = tuple(torch.repeat_interleave(f(ang), 2, -1).to(
        torch.bfloat16).cuda() for f in (torch.cos, torch.sin))
    mask = (torch.rand(B, N, generator=g) > 0.2).cuda()
    counts = lambda: (ak.hopper_attention.packs, ak.attention_fwd.launches,
                      ak.attention_bwd.launches)
    c0 = counts()
    y = block(x, enc, mask, training=True)
    c1 = counts()
    y.float().sum().backward()
    c2 = counts()
    assert tuple(b - a for a, b in zip(c0, c1)) == (1, 1, 0)
    assert tuple(b - a for a, b in zip(c1, c2)) == (0, 0, 1)
    assert all(torch.isfinite(p.grad.float()).all()
               for p in block.parameters())


def _g_operands(gen, B, h, N, M, d):
    """G's bf16 operands as the "flash" self-attention hands them: the
    rotated q, k contiguous head views, v the stride-3 view (packed)."""
    return _d_operands(gen, B, h, N, M, d, "self")


@pytest.mark.parametrize("N,M", [(1024, 1024), (2048, 2048), (200, 136)])
def test_flash_segment_hopper_loop(cuda, N, M):
    """G's bf16 instance (the Hopper loop in its segment mode) against the
    plain version: query ids that vary per row, key ids of three segments,
    batch row 1's keys in a segment no query has (every query row there
    gives the mean of V); without ids, no mask. One pack launch a call
    (the stride-3 v)."""
    from ei_nexus_tpu_torch.ops import flash_kernel as fk
    B, h, d = 2, 2, 64
    q, k, v = _g_operands(cuda, B, h, N, M, d)
    q_seg = torch.randint(0, 3, (B, N), generator=cuda, device="cuda",
                          dtype=torch.int32)
    kv_seg = torch.randint(0, 3, (B, M), generator=cuda, device="cuda",
                           dtype=torch.int32)
    kv_seg[1] = -5
    before, packs = fk.flash_attention.launches, ak.hopper_attention.packs
    got = fk.flash_attention(q, k, v, q_seg, kv_seg, d ** -0.5)
    assert fk.flash_attention.launches == before + 1
    assert ak.hopper_attention.packs == packs + 1
    assert torch.isfinite(got.float()).all()
    assert _close(got, fk.flash_attention_plain(q, k, v, q_seg, kv_seg,
                                                d ** -0.5))
    mean = v[1].float().mean(dim=1, keepdim=True).expand(-1, N, -1)
    assert _close(got[1], mean)
    assert torch.equal(fk.flash_attention(q, k, v, q_seg, kv_seg,
                                          d ** -0.5), got)
    got = fk.flash_attention(q, k, v, sm_scale=1.0)
    assert _close(got, fk.flash_attention_plain(q, k, v, sm_scale=1.0))


def test_d_and_g_refuse_what_the_plan_refuses(cuda):
    """A d stride of 2 is neither TMA's nor the pack pass's: D's and G's
    bf16 wrappers raise ValueError before any launch and take no other
    path."""
    from ei_nexus_tpu_torch.ops import flash_kernel as fk
    B, h, d, N = 1, 2, 64, 128
    x = torch.randn(B, h, N, 2 * d, generator=cuda, device="cuda").to(
        torch.bfloat16)
    q = x[..., ::2]
    k = v = x[..., :d].contiguous()
    bias = ak.key_bias(None, B, N, "cuda")
    counts = lambda: (ak.attention_fwd.launches, fk.flash_attention.launches,
                      ak.hopper_attention.packs)
    c0 = counts()
    with pytest.raises(ValueError):
        ak.attention_fwd(q, k, v, bias, 0.125)
    with pytest.raises(ValueError):
        ak.attention_fwd(k, k, q, bias, 0.125)
    with pytest.raises(ValueError):
        fk.flash_attention(q, k, v, sm_scale=0.125)
    assert counts() == c0


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


# ---------------------------------------------------------------------------
# the data path on the card: decode, the pinned put, the MNN matcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_decode_on_the_card(cuda, native):
    """The wire decoded on the card equals the CPU decode bit for bit, and
    x, y equal round(v * 64) / 64 of the encoder that ran; the voxel grid
    of the wire equals the one of the decoded float arrays (deterministic
    index_add_)."""
    import numpy as np
    from ei_nexus_tpu_torch.data.synth import bursty_event_batch
    from ei_nexus_tpu_torch.train import steps as ts

    rng = np.random.default_rng(0)
    H, W = 260, 346
    ev = bursty_event_batch(rng, 4, 30000, 1 << 18, H, W)
    ev["events_x"][:, :100] = (rng.integers(0, 345 * 64, (4, 100))
                               + 0.5).astype(np.float32) / 64
    enc = ts.compact_event_view(ev, keep=("image",), native=native)
    assert enc["events_xq"].shape[-1] == 32768
    dev = ts._decode_event_view(enc, "cuda")
    cpu = ts._decode_event_view(enc, "cpu")
    assert dev.keys() == cpu.keys()
    for k in cpu:
        assert dev[k].device.type == "cuda"
        assert torch.equal(dev[k].cpu(), cpu[k]), k
    v = ev["events_x"][:, :32768].astype(np.float64) * 64
    q = np.floor(v + 0.5) if native else np.round(v)
    assert torch.equal(dev["events_x"].cpu(),
                       torch.from_numpy((q / 64).astype(np.float32)))
    floats = {k: v.cpu() for k, v in dev.items()}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        a = ts.batch_representation(enc, "VoxelGrid", 16, H, W)
        b = ts.batch_representation(floats, "VoxelGrid", 16, H, W)
    finally:
        torch.use_deterministic_algorithms(False)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("switch", ["0", "1"])
def test_pinned_put_through_device_prefetch(cuda, monkeypatch, switch):
    """Batches through `device_prefetch` with a `PinnedPut`, the card kept
    busy so that the copies lag behind the puts: every batch arrives
    intact, its pinned buffers are held while its copy is pending, and
    none is left held once the stream is drained."""
    import numpy as np
    from ei_nexus_tpu_torch.data.pipeline import PinnedPut, device_prefetch

    monkeypatch.setenv("EI_NEXUS_DEVICE_PREFETCH", switch)
    rng = np.random.default_rng(1)
    batches = [{"xq": rng.integers(0, 1 << 16, (8, 65536), dtype=np.uint16),
                "n": rng.integers(0, 65536, 8).astype(np.int32),
                "image": rng.uniform(0, 255, (8, 260, 346, 1)).astype(
                    np.float32)} for _ in range(6)]
    big = torch.randn(4096, 4096, device="cuda")
    put = PinnedPut("cuda")
    got, held = [], []
    for out in device_prefetch(iter(batches), put):
        for _ in range(4):      # keep the stream busy behind the copies
            big = big @ big
            big = big / big.norm()
        held.append(put.in_flight)
        got.append({k: v.sum() for k, v in out.items()} | {"out": out})
    torch.cuda.synchronize()
    assert max(held) >= 1
    assert put.in_flight == 0
    for b, g in zip(batches, got):
        for k in b:
            assert g["out"][k].device.type == "cuda"
            assert torch.equal(g["out"][k].cpu(), torch.from_numpy(b[k])), k
    put.synchronize()


def test_mnn_on_the_card(cuda):
    """mnn_match on the card equals the CPU, with ties, masks and both
    thresholds (descriptors on a 1/4 grid: exact similarities)."""
    import numpy as np
    from ei_nexus_tpu_torch.models.mnn import mnn_match

    rng = np.random.default_rng(2)
    feats = []
    for K in (1024, 1000):
        feats.append({
            "sparse_descriptors": torch.from_numpy(
                rng.integers(-2, 3, (4, K, 16)).astype(np.float32) / 4),
            "sparse_valid": torch.from_numpy(rng.uniform(size=(4, K)) < 0.8)})
    for ratio, dist in ((None, None), (0.95, 1.5)):
        want = mnn_match(*feats, ratio, dist)
        got = mnn_match(*({k: v.cuda() for k, v in f.items()}
                          for f in feats), ratio, dist)
        for k in ("matches0", "matches1"):
            assert got[k].device.type == "cuda"
            assert torch.equal(got[k].cpu(), want[k]), k
        assert (want["matches0"] > -1).any()


def test_training_extractor_runs_kernel_c(cuda):
    """An event extractor in train() with gradients enabled: its keypoint
    forward takes kernel C on the card without raising (the NMS reads a
    detached map), and the selection carries no gradient."""
    from ei_nexus_tpu_torch.models.extractor import (KeypointExtractorConfig,
                                                     VGGExtractor)
    from ei_nexus_tpu_torch.models.layers import init_parameters

    model = VGGExtractor(KeypointExtractorConfig(detection_top_k=64),
                         in_channels=4, feat_channels=16, descriptor_dim=32,
                         lat_channels=32)
    init_parameters(model, torch.Generator().manual_seed(0))
    model = model.cuda().train()
    x = torch.randn(2, 64, 96, 4, generator=cuda, device="cuda")
    mask = torch.rand(2, 64, 96, generator=cuda, device="cuda") > 0.3
    before = nk.nms_rounds.launches
    with torch.enable_grad():
        out = model(x, mask)
    torch.cuda.synchronize()
    assert nk.nms_rounds.launches == before + 1
    assert out["sparse_positions"].grad_fn is None
    assert out["nms"].grad_fn is None
    assert out["score"].grad_fn is not None
    out["sparse_descriptors"].sum().backward()
    assert next(model.parameters()).grad is not None


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 0.0)])
def test_batchnorm_training_on_the_card(cuda, dtype, tol):
    """BatchNorm in train() at B*H*W = 48 on the card against the CPU:
    output and running statistics to 1e-5 in float32; in bfloat16 the
    output equal to the CPU's after its float32 reductions, rounded (one
    bfloat16 ulp apart at most)."""
    from ei_nexus_tpu_torch.models.layers import BatchNorm

    x = (1.5 + 2.0 * torch.randn(3, 8, 4, 4, generator=cuda,
                                 device="cuda")).to(dtype)
    gpu, cpu = BatchNorm(8).cuda().train(), BatchNorm(8).train()
    with torch.no_grad():
        for bn in (gpu, cpu):
            bn.weight.copy_(torch.linspace(0.5, 1.5, 8))
            bn.bias.copy_(torch.linspace(-0.1, 0.1, 8))
    y_gpu, y_cpu = gpu(x), cpu(x.cpu())
    assert y_gpu.dtype == dtype
    if dtype == torch.float32:
        assert (y_gpu.cpu() - y_cpu).abs().max() <= tol
    else:   # a float32 difference may round to the neighbouring bfloat16
        ulp = y_cpu.float().abs().clamp(min=1e-3) * 2 ** -7
        assert ((y_gpu.cpu().float() - y_cpu.float()).abs() <= ulp).all()
    for k in ("running_mean", "running_var"):
        diff = (getattr(gpu, k).cpu() - getattr(cpu, k)).abs().max()
        assert diff <= 1e-5, k


def test_stage1_step_on_the_card(cuda):
    """One stage-1 step of the tiny float32 config on the CPU and on the
    card from the same weights and batch: loss and grad_norm close,
    updated parameters within 4 lr (Adam's first step moves a parameter by
    about lr whatever its gradient's size), running statistics to 1e-4,
    the frozen SuperPoint bit-unchanged on both. TF32 is off for the
    card's convolutions too (cuDNN's default is on; with it grad_norm read
    2.8e-3 apart, its 10-bit mantissa's rounding)."""
    import copy
    import numpy as np
    from ei_nexus_tpu_torch.data.synth import bursty_event_batch
    from ei_nexus_tpu_torch.flagship import (STAGE1_LOSSES, STAGE1_LR,
                                             build_stage1_flagship,
                                             stage1_train_state)
    from ei_nexus_tpu_torch.losses import build_losses
    from ei_nexus_tpu_torch.train.steps import make_stage1_train_step

    cpu_model, (H, W, bins) = build_stage1_flagship(
        tiny=True, dtype="float32", device="cpu")
    gpu_model = copy.deepcopy(cpu_model).cuda()
    start = {k: v.clone() for k, v in cpu_model.state_dict().items()}
    rng = np.random.default_rng(1)
    view = bursty_event_batch(rng, 2, 3000, 4096, H, W)
    view["image"] = rng.uniform(0, 255, (2, H, W, 1)).astype(np.float32)
    losses = build_losses({k: v for k, v in STAGE1_LOSSES.items()
                           if k != "feature_loss"})
    step = make_stage1_train_step(losses, "VoxelGrid", bins, H, W)
    infos = {}
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for name, model in (("cpu", cpu_model), ("cuda", gpu_model)):
            infos[name] = {k: float(v) for k, v in
                           step(stage1_train_state(model), (view,)).items()}
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    ic, ig = infos["cpu"], infos["cuda"]
    assert abs(ig["loss"] - ic["loss"]) <= 1e-4 * abs(ic["loss"])
    assert abs(ig["grad_norm"] - ic["grad_norm"]) <= 1e-3 * ic["grad_norm"]
    sc = cpu_model.state_dict()
    sg = {k: v.cpu() for k, v in gpu_model.state_dict().items()}
    for k in sc:
        if k.startswith("image_extractor."):
            assert torch.equal(sg[k], start[k]) and torch.equal(sc[k],
                                                                start[k]), k
        elif k.endswith(("running_mean", "running_var")):
            assert (sg[k] - sc[k]).abs().max() <= 1e-4, k
        else:
            assert (sg[k] - sc[k]).abs().max() <= 4 * STAGE1_LR, k


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 260, 346), (2, 242, 328)],
                         ids=["cell1-padding1", "cell1-padding0"])
def test_nms_kernel_cell1_shapes(cuda, dtype, shape):
    """Kernel C at the cell-1 extractors' full-resolution score maps:
    MVSEC's 260x346 unpadded (padding 1) and 18 px smaller (padding 0),
    bit-exact against the plain version."""
    s = torch.rand(*shape, generator=cuda, device="cuda")
    s = torch.where(s > 0.3, s, torch.zeros_like(s)).to(dtype)
    before = nk.nms_rounds.launches
    assert torch.equal(nk.nms_rounds(s, 4, 4), nk.nms_rounds_plain(s, 4, 4))
    assert nk.nms_rounds.launches == before + 1


@pytest.mark.parametrize("name,padding", [("EI_SiLK_LG", 1),
                                          ("EI_SiLK_MNN", 0)])
def test_tiny_silk_forward_on_the_card(cuda, name, padding):
    """The tiny float32 SiLK-family EIM on the CPU and on the card (kernel
    C on the card, the same fixed 4 NMS rounds on the CPU), same weights
    and inputs: keypoints, validity and matches equal, maps to 1e-4."""
    import copy
    import dataclasses
    import numpy as np
    from ei_nexus_tpu_torch.data.synth import bursty_event_batch
    from ei_nexus_tpu_torch.flagship import build_silk
    from ei_nexus_tpu_torch.train.steps import batch_representation

    cpu_model, (H, W, bins) = build_silk(
        name, tiny=True, dtype="float32", device="cpu",
        generator=torch.Generator().manual_seed(5), padding=padding)
    for ex in (cpu_model.event_extractor, cpu_model.image_extractor):
        ex.config = dataclasses.replace(ex.config, nms_impl="pallas")
    gpu_model = copy.deepcopy(cpu_model).cuda()
    rng = np.random.default_rng(5)
    ev = bursty_event_batch(rng, 2, 3000, 4096, H, W)
    image = torch.as_tensor(rng.uniform(0, 255, (2, H, W, 1)).astype(
        np.float32))
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    try:
        with torch.inference_mode():
            for dev, model in (("cpu", cpu_model), ("cuda", gpu_model)):
                rep, mask = batch_representation(ev, "VoxelGrid", bins, H,
                                                 W, device=dev)
                before = nk.nms_rounds.launches
                out[dev] = model(rep, image.to(dev), mask if padding else None)
                if dev == "cuda":
                    torch.cuda.synchronize()
                    assert nk.nms_rounds.launches == before + 2
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    (e_c, i_c, m_c), (e_g, i_g, m_g) = out["cpu"], out["cuda"]
    for a, b in ((e_c, e_g), (i_c, i_g)):
        assert torch.equal(a["sparse_positions"][..., :2],
                           b["sparse_positions"][..., :2].cpu())
        assert torch.equal(a["sparse_valid"], b["sparse_valid"].cpu())
        for k in ("score", "sparse_descriptors", "raw_descriptors"):
            assert (a[k] - b[k].cpu()).abs().max() <= 1e-4, k
    for k in ("matches0", "matches1"):
        assert torch.equal(m_c[k], m_g[k].cpu()), k


@pytest.mark.parametrize("kind", ["VoxelGrid", "TimeSurface", "EventStack",
                                  "DistanceMap", "AccumulationImage"])
def test_representations_on_the_card(cuda, kind):
    """Each representation on the card against the CPU on the same bursty
    events: bit-equal, but for the voxel grid, whose atomic float sums run
    in another order (to 1e-5, and a zero may read ~1e-8)."""
    import numpy as np
    from ei_nexus_tpu_torch.data.synth import bursty_event_batch
    from ei_nexus_tpu_torch.train.steps import batch_representation

    H, W, bins = 60, 80, 6
    ev = bursty_event_batch(np.random.default_rng(6), 2, 6000, 8192, H, W)
    want, want_mask = batch_representation(ev, kind, bins, H, W,
                                           device="cpu")
    got, mask = batch_representation(ev, kind, bins, H, W, device="cuda")
    assert torch.equal(mask.cpu(), want_mask)
    if kind == "VoxelGrid":
        assert (got.cpu() - want).abs().max() <= 1e-5
    else:
        assert torch.equal(got.cpu(), want)
    assert (want != 0).any()


def _grid_stage2_model():
    """The tiny float32 stage-2 flagship with LightGlue on the kernels'
    shape grid: 128 slots, 2 heads of 64 (its 32-d descriptors projected
    to 128), so D and F (training) and A and B (inference) take every
    attention call; (model on the CPU with training heads, (H, W, bins))."""
    import dataclasses
    from ei_nexus_tpu_torch.flagship import stage2_config
    from ei_nexus_tpu_torch.models.eim import EIM
    from ei_nexus_tpu_torch.models.layers import init_parameters

    cfg, shape = stage2_config(tiny=True, dtype="float32")
    # 4 fixed NMS rounds on both devices (the CPU's "auto" runs the loop
    # to convergence)
    kp = dataclasses.replace(cfg.event_extractor.keypoints,
                             nms_impl="pallas")
    cfg = dataclasses.replace(
        cfg,
        event_extractor=dataclasses.replace(cfg.event_extractor,
                                            keypoints=kp),
        image_extractor=dataclasses.replace(cfg.image_extractor,
                                            keypoints=kp),
        matcher=dataclasses.replace(
            cfg.matcher, max_points_num=128,
            lightglue=dataclasses.replace(cfg.matcher.lightglue,
                                          descriptor_dim=128, num_heads=2)))
    model = EIM(cfg, training_heads=True)
    init_parameters(model, torch.Generator().manual_seed(0))
    return model, shape


def test_homography_step_on_the_card(cuda):
    """One homography-supervised stage-2 step of the small on-grid model
    on the CPU and on the card, the same weights, batch, corner jitter and
    slot fill: the card launches D and F 4 a layer and C twice; H and
    image1 agree (image1 within what the two devices' float32 H^-1 move
    the sampling points: max|image| per pixel moved), loss and grad_norm to
    1e-4 and 1e-3 relative, updated parameters within 4 lr, frozen
    tensors bit-unchanged. TF32 off for matmuls and convolutions."""
    import copy
    import numpy as np
    from ei_nexus_tpu_torch.data.synth import homography_batch
    from ei_nexus_tpu_torch.flagship import STAGE2_LR, stage2_train_state
    from ei_nexus_tpu_torch.models.eim import random_fill
    from ei_nexus_tpu_torch.ops import homographic as hg
    from ei_nexus_tpu_torch.train.steps import (
        homography_view, make_stage2_homography_train_step)

    cpu_model, (H, W, bins) = _grid_stage2_model()
    gpu_model = copy.deepcopy(cpu_model).cuda()
    start = {k: v.clone() for k, v in cpu_model.state_dict().items()}
    batch = homography_batch(np.random.default_rng(2), 2, 3000, 4096, H, W)
    gen = torch.Generator().manual_seed(5)
    jitter = (torch.rand(2, 4, 2, generator=gen) * 2 - 1) \
        * torch.tensor([W, H]) * 0.125
    feats = {"sparse_positions": torch.zeros(2, 1, 3),
             "sparse_descriptors": torch.zeros(2, 1, 32),
             "image_size": torch.tensor([[H, W]] * 2)}
    fill = tuple(random_fill(feats, 128, 1.0, gen) for _ in range(2))

    Hc, ic = homography_view(torch.as_tensor(batch[0]["image"]), jitter, H,
                             W)
    Hg, ig = homography_view(torch.as_tensor(batch[0]["image"]).cuda(),
                             jitter.cuda(), H, W)
    assert (Hg.cpu() - Hc).abs().max() <= 1e-4 * Hc.abs().max()
    grid = hg.create_meshgrid(W, H, normalized=False).reshape(-1, 2)
    moved = (hg.transform_points(torch.linalg.inv_ex(Hg)[0],
                                 grid.cuda()).cpu()
             - hg.transform_points(torch.linalg.inv_ex(Hc)[0],
                                   grid)).abs().sum(-1).max()
    assert (ig.cpu() - ic).abs().max() <= (1e-5 + float(moved)) * 255

    step = make_stage2_homography_train_step("VoxelGrid", bins, H, W)
    counters = (ak.attention_fwd, ak.attention_bwd, nk.nms_rounds)
    infos = {}
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for name, model in (("cpu", cpu_model), ("cuda", gpu_model)):
            dev = next(model.parameters()).device
            before = [c.launches for c in counters]
            info = step(stage2_train_state(model), batch,
                        fill=tuple((p.to(dev), d.to(dev)) for p, d in fill),
                        jitter=jitter.to(dev))
            infos[name] = {k: float(v) for k, v in info.items()}
            launched = [c.launches - b for c, b in zip(counters, before)]
            assert launched == ([0, 0, 0] if name == "cpu" else [8, 8, 2])
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    ic_, ig_ = infos["cpu"], infos["cuda"]
    assert np.isfinite(ig_["loss"]) and ig_["gt_matches"] >= 0
    assert abs(ig_["loss"] - ic_["loss"]) <= 1e-4 * abs(ic_["loss"])
    assert abs(ig_["grad_norm"] - ic_["grad_norm"]) \
        <= 1e-3 * ic_["grad_norm"]
    sc = cpu_model.state_dict()
    sg = {k: v.cpu() for k, v in gpu_model.state_dict().items()}
    for k in sc:
        if k.startswith("matcher."):
            assert (sg[k] - sc[k]).abs().max() <= 4 * STAGE2_LR, k
        else:
            assert torch.equal(sg[k], start[k]) and torch.equal(sc[k],
                                                                start[k]), k


def test_eval_forward_launches_a_b_c(cuda):
    """`rpe_eval` on the card (both RANSAC backends) over one batch of the
    small on-grid model: its eval forward launches A for each layer's two
    self-attentions, B once a layer and C once an extractor, as the shape
    guard predicts for 128 slots and heads of 64; the metrics are
    finite."""
    import numpy as np
    from ei_nexus_tpu_torch.data.synth import stage2_batch
    from ei_nexus_tpu_torch.models.lightglue import _pallas_supported
    from ei_nexus_tpu_torch.train.evaluate import rpe_eval

    model, (H, W, bins) = _grid_stage2_model()
    model = model.cuda().eval()
    batch = stage2_batch(np.random.default_rng(3), 2, 3000, 4096, H, W)
    layers = model.config.matcher.lightglue.n_layers
    assert _pallas_supported(128, 64) and _pallas_supported(128, 64, 128)
    counters = (ak.self_attention, ak.cross_attention_bidir, nk.nms_rounds)
    for backend in ("opencv", "torch"):
        before = [c.launches for c in counters]
        out = rpe_eval(model, [batch], "VoxelGrid", bins, H, W,
                       backend=backend)
        launched = [c.launches - b for c, b in zip(counters, before)]
        assert launched == [2 * layers, layers, 2]
        assert out["n_pairs"] == 2
        assert all(np.isfinite(out[f"RPE@{t}_auc"]) for t in (5, 10, 20))


@pytest.mark.parametrize("regime", ["defaults", "never_exit",
                                    "exit_after_layer_0", "prune_all",
                                    "prune_some"])
def test_adaptive_lightglue_on_the_card(cuda, regime):
    """A tiny float32 adaptive LightGlue on the kernels' grid (3 layers,
    128 tokens, 2 heads of 64) on the CPU (plain versions) and the card
    (A and B, fed the pruned key masks), in steered regimes: exit layer,
    surviving masks and matches equal, log-assignment within 1e-3 (atol;
    float32 kernels, online softmax); A twice and B once a layer run."""
    import numpy as np
    from ei_nexus_tpu_torch.models.layers import init_parameters
    from ei_nexus_tpu_torch.models.lightglue import (LightGlue,
                                                     LightGlueConfig)
    rng = np.random.default_rng(5)
    B, N, D = 2, 128, 128

    def feats():
        return {"sparse_descriptors": torch.as_tensor(
                    rng.normal(size=(B, N, D)).astype(np.float32)),
                "sparse_positions": torch.as_tensor(np.concatenate(
                    [rng.uniform(0, 60, (B, N, 2)),
                     rng.uniform(0, 1, (B, N, 1))], -1).astype(np.float32)),
                "sparse_valid": torch.as_tensor(
                    rng.uniform(size=(B, N)) > 0.1),
                "image_size": torch.full((B, 2), 64.0)}

    f0, f1 = feats(), feats()
    extra = dict(width_confidence=0.99) if regime.startswith("prune") \
        else dict(depth_confidence=0.95, width_confidence=0.99)
    model = LightGlue(LightGlueConfig(input_dim=D, descriptor_dim=D,
                                      n_layers=3, num_heads=2, **extra))
    init_parameters(model, torch.Generator().manual_seed(3))
    with torch.no_grad():
        for i in range(2):
            tok = model.token_confidence[str(i)].bias
            mat = model.log_assignment[str(i)].matchability.bias
            if regime == "never_exit":
                tok.fill_(-10.0)
            elif regime == "exit_after_layer_0":
                tok.fill_(10.0)
            elif regime == "prune_all":
                mat.fill_(-10.0)
            elif regime == "prune_some":
                mat.fill_(-4.0)
    with torch.inference_mode():
        c = model.eval()(f0, f1)
        before = (ak.self_attention.launches,
                  ak.cross_attention_bidir.launches)
        g = model.cuda()({k: v.cuda() for k, v in f0.items()},
                         {k: v.cuda() for k, v in f1.items()})
        torch.cuda.synchronize()
    layers = int(c["exit_layer"]) + 1
    assert (ak.self_attention.launches - before[0],
            ak.cross_attention_bidir.launches - before[1]) == (2 * layers,
                                                               layers)
    for k in ("exit_layer", "surviving0", "surviving1", "matches0",
              "matches1"):
        assert torch.equal(g[k].cpu(), c[k]), k
    assert (g["log_assignment"].cpu() - c["log_assignment"]).abs().max() \
        <= 1e-3
    if regime == "prune_all":
        assert not c["surviving0"].any() and (c["matches0"] == -1).all()


def test_ba_on_the_card_matches_the_cpu(cuda):
    """`ba_solve` on a small exact problem (chip_smoke's ring of 6
    cameras, 120 landmarks) on the CPU and the card, plain and with Huber
    4 px and z_min 0.01: the initial costs to rtol 1e-5, the first
    iteration's to 1e-4 of the initial cost (what that step leaves, ~3e-4
    of it, carries the summation order, which the card's atomic
    `index_add_` changes from run to run), refined poses to atol 1e-4 and
    points to atol 1e-3; both converge. No host sync in the solve."""
    import numpy as np
    import chip_smoke
    from ei_nexus_tpu_torch.parallel.ba import ba_solve
    prob = chip_smoke._ring_problem(np.random.default_rng(13))
    for kw in ({}, dict(huber_delta=4.0, z_min=0.01)):
        rc, ec = ba_solve(prob, iters=10, cg_iters=25, **kw)
        on_card = prob.to("cuda")
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            rg, eg = ba_solve(on_card, iters=10, cg_iters=25, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        eg, rg = eg.cpu(), rg.to("cpu")
        assert abs(eg[0] - ec[0]) <= 1e-5 * ec[0]
        assert abs(eg[1] - ec[1]) <= 1e-4 * ec[0]
        assert (rg.poses - rc.poses).abs().max() <= 1e-4
        assert (rg.points - rc.points).abs().max() <= 1e-3
        assert ec[-1] < 1e-3 and eg[-1] < 1e-3


def test_pth_loads_on_the_card(cuda, tmp_path):
    """A reference `.pth` (the tiny flagship's seeded weights in the
    reference's layout) read by `restore_any_checkpoint` into a model on
    the card: every tensor bit-equal to the source."""
    import types
    from ei_nexus_tpu_torch.flagship import flagship_config
    from ei_nexus_tpu_torch.models.eim import EIM
    from ei_nexus_tpu_torch.models.layers import init_parameters
    from ei_nexus_tpu_torch.models.port_torch import to_reference_layout
    from ei_nexus_tpu_torch.train import restore_any_checkpoint
    cfg, _ = flagship_config(tiny=True, dtype="float32")
    src = EIM(cfg, training_heads=True)
    init_parameters(src, torch.Generator().manual_seed(7))
    path = tmp_path / "eim.pth"
    torch.save(to_reference_layout(src.state_dict()), path)
    model = EIM(cfg, training_heads=True).cuda()
    restore_any_checkpoint(str(path), types.SimpleNamespace(model=model),
                           cfg)
    for k, v in src.state_dict().items():
        got = model.state_dict()[k]
        assert got.is_cuda and torch.equal(got.cpu(), v), k


# kernel L (ops/linear_kernel.py): (M, K, N, parts of K, residual); the
# flagship's shapes (a 16-pair batch of 1024 slots a side), a ragged M, K
# not a multiple of the 32-column chunk, the FFN's two parts of K
LINEAR_CASES = [(16384, 256, 768, 1, False), (16384, 256, 256, 1, False),
                (16384, 512, 512, 2, False), (16384, 512, 256, 1, True),
                (3001, 256, 256, 1, False), (77, 36, 12, 1, True),
                (130, 100, 20, 2, True)]


@pytest.mark.parametrize("M,K,N,parts,res", LINEAR_CASES)
def test_linear_kernel(cuda, M, K, N, parts, res):
    """Kernel L against a float64 product within the 3xTF32 tolerance of
    csrc/flash_tf32.cuh, 1e-4 x max(1, max|ref|); one launch a call."""
    from ei_nexus_tpu_torch.ops import linear_kernel as lk
    x = torch.randn(M, K, generator=cuda, device="cuda")
    w = torch.randn(N, K, generator=cuda, device="cuda") * K ** -0.5
    b = torch.randn(N, generator=cuda, device="cuda") * 0.1
    r = torch.randn(M, N, generator=cuda, device="cuda") if res else None
    k0 = 64 if K == 100 else K // 2
    xs = (x[:, :k0], x[:, k0:]) if parts == 2 else x
    before = lk.linear_tf32.launches
    got = lk.linear_tf32(xs, w, b, r)
    torch.cuda.synchronize()
    assert lk.linear_tf32.launches == before + 1
    ref = torch.nn.functional.linear(x.double(), w.double(), b.double())
    if res:
        ref = ref + r.double()
    assert float((got.double() - ref).abs().max()) \
        <= 1e-4 * max(1.0, float(ref.abs().max()))


def test_linear_kernel_lightglue_forward(cuda, monkeypatch):
    """A float32 LightGlue forward on the card through kernel L against the
    same forward with every linear on F.linear (cuBLAS): one launch a routed
    call (18 a layer, 2 for the assignment head), the weights split once,
    the log assignment within 1e-3 and the matches alike."""
    from ei_nexus_tpu_torch.models import layers
    from ei_nexus_tpu_torch.models.layers import init_parameters
    from ei_nexus_tpu_torch.models.lightglue import LightGlue, LightGlueConfig
    from ei_nexus_tpu_torch.ops import linear_kernel as lk
    B, N, D, L = 2, 256, 256, 2
    model = LightGlue(LightGlueConfig(n_layers=L))
    init_parameters(model, torch.Generator().manual_seed(11))
    model = model.eval().cuda()

    def feats():
        return {"sparse_descriptors": torch.randn(B, N, D, generator=cuda,
                                                  device="cuda"),
                "sparse_positions": torch.rand(B, N, 3, generator=cuda,
                                               device="cuda") * 60,
                "sparse_valid": torch.rand(B, N, generator=cuda,
                                           device="cuda") > 0.1,
                "image_size": torch.full((B, 2), 64.0, device="cuda")}

    f0, f1 = feats(), feats()
    counts = []
    with torch.inference_mode():
        for _ in range(2):
            before = (lk.linear_tf32.launches, lk.linear_tf32.plane_builds)
            got = model(f0, f1)
            torch.cuda.synchronize()
            counts.append((lk.linear_tf32.launches - before[0],
                           lk.linear_tf32.plane_builds - before[1]))
        monkeypatch.setattr(layers, "linear_route", lambda *a: False)
        before = lk.linear_tf32.launches
        want = model(f0, f1)
        assert lk.linear_tf32.launches == before
    assert counts == [(18 * L + 2, 9 * L + 1), (18 * L + 2, 0)]
    gap = (got["log_assignment"] - want["log_assignment"]).abs().max()
    assert float(gap) <= 1e-3
    same = (got["matches0"] == want["matches0"]).float().mean()
    assert float(same) >= 0.99
