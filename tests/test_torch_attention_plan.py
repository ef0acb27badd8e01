"""The operand plan of the Hopper loops of kernels A, B, D, E, F and G
(`ops/attention_kernels.py:operand_plan`) on CPU tensors: which operands
TMA reads in place, which the pack pass writes first (with the slab and
phase it reads them from), and which neither takes; and the operands the
LightGlue blocks hand D and F (training), B (inference) and G ("flash").
The plan looks only at shapes, strides and addresses, so CPU tensors stand
for the card's."""

import pytest
import torch

from ei_nexus_tpu_torch.ops.attention_kernels import operand_plan
from tests.test_torch_threads import one_torch_thread  # noqa: F401

B, N, H, D = 8, 1024, 4, 64   # the flagship's LightGlue: 4 heads of 64


def _wqkv(n=N, dtype=torch.bfloat16):
    """SelfBlock's split of a Wqkv output: (B, H, n, D) views at d stride 3
    of one (B, n, H, D, 3) buffer."""
    w = torch.zeros(B, n, H * D * 3, dtype=dtype)
    qkv = w.unflatten(-1, (H, D, 3)).transpose(1, 2)
    return w, (qkv[..., 0], qkv[..., 1], qkv[..., 2])


@pytest.mark.parametrize("phase", [0, 1, 2])
@pytest.mark.parametrize("rotate", [False, True])
def test_wqkv_views_are_packed_from_their_slab(phase, rotate):
    w, views = _wqkv()
    plan = operand_plan(views[phase], rotate)
    assert plan.mode == "pack"
    assert plan.ptr == w.data_ptr()          # the (0, 0, 0) head slab
    assert plan.phase == phase and plan.sd == 3
    assert plan.strides == (N * H * D * 3, D * 3, H * D * 3)
    assert plan.ptr % 16 == 0


def test_wqkv_views_of_a_later_row_keep_their_slab():
    """A view starting at token 5, head 1: the slab is that row's 384
    bytes, 16-byte aligned, the phase unchanged."""
    w, (q, k, v) = _wqkv()
    for phase, t in enumerate((q, k, v)):
        plan = operand_plan(t[:, 1:, 5:], rotate=phase < 2)
        assert plan.mode == "pack" and plan.phase == phase
        assert plan.ptr == w.data_ptr() + 2 * (5 * H * D * 3 + D * 3)


def test_cross_head_views_are_read_in_place():
    """CrossBlock's pre-scaled head views: unit d stride, rows 512 bytes
    apart; no rotary, so TMA reads them directly."""
    x = torch.zeros(B, N, H * D, dtype=torch.bfloat16)
    qk = x.unflatten(-1, (H, D)).transpose(1, 2) * 0.35
    plan = operand_plan(qk)
    assert plan.mode == "direct" and plan.ptr == qk.data_ptr()
    assert plan.strides == (N * H * D, D, H * D) and plan.sd == 1
    # the same view with the rotary to apply is packed (phase 0)
    plan = operand_plan(qk, rotate=True)
    assert plan.mode == "pack" and plan.ptr == qk.data_ptr()
    assert (plan.sd, plan.phase) == (1, 0)


def test_size_one_dimensions_take_an_aligned_stride():
    x = torch.zeros(1, 1, 100, D, dtype=torch.bfloat16)
    x = x.as_strided(x.shape, (7, 3, D, 1))      # odd strides, never used
    assert operand_plan(x).mode == "direct"


@pytest.mark.parametrize("make", [
    # d stride 2: neither TMA nor the pack pass
    lambda: torch.zeros(B, H, N, 2 * D, dtype=torch.bfloat16)[..., ::2],
    # unit d stride, rows 2 bytes off 16 (and the rotary forces a pack)
    lambda: torch.zeros(B, H, N * D + 1, dtype=torch.bfloat16)[
        ..., 1:].unflatten(-1, (N, D)),
    # a row stride that is not a multiple of 8 elements
    lambda: torch.zeros(B, H, N, D + 4, dtype=torch.bfloat16)[..., :D],
    # d stride 3 at a slab that is not 16-byte aligned
    lambda: torch.zeros(B * N * H * D * 3 + 3, dtype=torch.bfloat16)[
        3:].view(B, N, H, D, 3).transpose(1, 2)[..., 1],
    # not a head of 64
    lambda: torch.zeros(B, H, N, 32, dtype=torch.bfloat16),
    # 4-byte elements
    lambda: torch.zeros(B, H, N, D),
])
def test_what_neither_reads_raises(make):
    with pytest.raises(ValueError):
        operand_plan(make(), rotate=True)


def test_misaligned_unit_stride_raises_without_rotary_too():
    x = torch.zeros(B * H * N * D + 1, dtype=torch.bfloat16)[1:]
    with pytest.raises(ValueError):
        operand_plan(x.view(B, H, N, D))


def test_a_slab_outside_the_storage_raises():
    """The pack pass reads a row's whole 384-byte slab: a stride-3 view at
    phase 0 whose storage ends inside its last slab (the last two elements,
    phases 1 and 2 of d = 63, are missing) is refused."""
    slabs = 2 * H                              # 2 tokens of H heads
    storage = torch.zeros(slabs * D * 3 - 2, dtype=torch.bfloat16)
    t = torch.as_strided(storage, (1, H, 2, D),
                         (2 * H * D * 3, D * 3, H * D * 3, 3))
    with pytest.raises(ValueError):
        operand_plan(t, rotate=True)
    whole = torch.zeros(slabs * D * 3, dtype=torch.bfloat16)
    assert operand_plan(torch.as_strided(whole, t.shape, t.stride()),
                        rotate=True).mode == "pack"


# ---------------------------------------------------------------------------
# what the LightGlue blocks hand kernels B, D, F and G, at the flagship's
# width and token counts on the kernels' shape grid (multiples of 128)
# ---------------------------------------------------------------------------

EMBED, HEADS = 256, 4     # 4 heads of 64
N1, M1 = 128, 256         # token counts of the two sides


def _rotary(b, n, gen):
    ang = torch.rand(b, 1, n, D // 2, generator=gen) * 6.28
    return tuple(torch.repeat_interleave(f(ang), 2, -1).to(torch.bfloat16)
                 for f in (torch.cos, torch.sin))


def _capture_fwd(monkeypatch):
    """Record the operands `_FusedAttention.forward` hands kernel D and the
    v it gets back. On the card D returns the contiguous copy its pack pass
    wrote of a v it packs; the plain version on the CPU packs nothing, so
    the spy hands on the copy the pack pass would write."""
    from ei_nexus_tpu_torch.ops import attention_kernels as ak
    seen, real = [], ak.attention_fwd

    def spy(q, k, v, bias, scale):
        out, stats, v_read = real(q, k, v, bias, scale)
        if operand_plan(v).mode == "pack":
            v_read = torch.empty(v.shape, dtype=v.dtype).copy_(v)
        seen.append(dict(q=q, k=k, v=v, v_read=v_read))
        return out, stats, v_read
    monkeypatch.setattr(ak, "attention_fwd", spy)
    return seen


def _capture_bwd(monkeypatch):
    """Record the operands `_FusedAttention.backward` hands kernel F."""
    from ei_nexus_tpu_torch.ops import attention_kernels as ak
    seen, real = [], ak.attention_bwd

    def spy(q, k, v, do, *rest, **kw):
        seen.append(dict(q=q, k=k, v=v, do=do))
        return real(q, k, v, do, *rest, **kw)
    monkeypatch.setattr(ak, "attention_bwd", spy)
    return seen


def _self_block_step(impl, gen, training):
    from ei_nexus_tpu_torch.models.lightglue import SelfBlock
    b = 2
    block = SelfBlock(EMBED, HEADS, dtype=torch.bfloat16, attn_impl=impl)
    x = torch.randn(b, N1, EMBED, generator=gen).to(torch.bfloat16)
    mask = torch.rand(b, N1, generator=gen) > 0.2
    with torch.set_grad_enabled(training):
        y = block(x, _rotary(b, N1, gen), mask, training=training)
        if training:
            y.float().sum().backward()


def _cross_block_step(impl, gen, training):
    from ei_nexus_tpu_torch.models.lightglue import CrossBlock
    b = 2
    block = CrossBlock(EMBED, HEADS, dtype=torch.bfloat16, attn_impl=impl)
    x0 = torch.randn(b, N1, EMBED, generator=gen).to(torch.bfloat16)
    x1 = torch.randn(b, M1, EMBED, generator=gen).to(torch.bfloat16)
    masks = (torch.rand(b, N1, generator=gen) > 0.2,
             torch.rand(b, M1, generator=gen) > 0.2)
    with torch.set_grad_enabled(training):
        y0, y1 = block(x0, x1, *masks, training=training)
        if training:
            (y0.float().sum() + y1.float().sum()).backward()


def _assert_wqkv_v(v, n):
    """v is the stride-3 view of a (B, n, H, D, 3) Wqkv output, packed from
    its 384-byte slab at phase 2."""
    plan = operand_plan(v)
    assert plan.mode == "pack" and (plan.sd, plan.phase) == (3, 2)
    assert plan.ptr == v.data_ptr() - 4
    assert plan.strides == (n * EMBED * 3, D * 3, EMBED * 3)


def test_selfblock_hands_d_its_v_packed_q_and_k_in_place(monkeypatch):
    """SelfBlock in training (kernel D): the rotated q and k are read in
    place; v, the stride-3 view of the Wqkv output, is packed from its slab
    at phase 2."""
    seen = _capture_fwd(monkeypatch)
    _self_block_step("pallas", torch.Generator().manual_seed(0), True)
    assert len(seen) == 1
    for name in ("q", "k"):
        assert operand_plan(seen[0][name]).mode == "direct", name
    _assert_wqkv_v(seen[0]["v"], N1)


def test_selfblock_hands_f_its_v_packed_the_rest_in_place(monkeypatch):
    """SelfBlock in training (kernels D/F): F gets the v D returns, D's
    packed copy, which it reads in place with the rotated q and k and dO;
    so F packs nothing."""
    fwd = _capture_fwd(monkeypatch)
    seen = _capture_bwd(monkeypatch)
    _self_block_step("pallas", torch.Generator().manual_seed(0), True)
    assert len(fwd) == 1 and len(seen) == 1
    ops = seen[0]
    assert ops["v"] is fwd[0]["v_read"]
    assert ops["v"].is_contiguous()
    for name in ("q", "k", "v", "do"):
        assert operand_plan(ops[name]).mode == "direct", name


def test_crossblock_hands_f_its_operands_in_place(monkeypatch):
    """CrossBlock in training: both directions' q, k, v (pre-scaled head
    views) and dO are read in place, by D and by F."""
    fwd = _capture_fwd(monkeypatch)
    seen = _capture_bwd(monkeypatch)
    _cross_block_step("pallas", torch.Generator().manual_seed(1), True)
    assert len(fwd) == 2 and len(seen) == 2
    for ops in fwd + seen:
        for name, t in ops.items():
            assert operand_plan(t).mode == "direct", name


def test_crossblock_hands_b_its_operands_in_place(monkeypatch):
    """CrossBlock at inference (kernel B): qk0, qk1, v0, v1 are head views
    TMA reads in place; no pack pass."""
    from ei_nexus_tpu_torch.models import lightglue
    seen, real = [], lightglue.cross_attention_bidir

    def spy(qk0, qk1, v0, v1, *rest, **kw):
        seen.append((qk0, qk1, v0, v1))
        return real(qk0, qk1, v0, v1, *rest, **kw)
    monkeypatch.setattr(lightglue, "cross_attention_bidir", spy)
    _cross_block_step("pallas", torch.Generator().manual_seed(2), False)
    assert len(seen) == 1
    shapes = [(2, HEADS, r, D) for r in (N1, M1, N1, M1)]
    for t, shape in zip(seen[0], shapes):
        assert tuple(t.shape) == shape
        plan = operand_plan(t)
        assert plan.mode == "direct" and plan.ptr == t.data_ptr()
        assert plan.strides[1:] == (D, EMBED)     # (B, N, h, d) head views


def _capture_flash(monkeypatch):
    """Record the q, k, v the "flash" blocks hand kernel G."""
    from ei_nexus_tpu_torch.models import lightglue
    seen, real = [], lightglue.flash_attention

    def spy(q, k, v, *rest, **kw):
        seen.append(dict(q=q, k=k, v=v))
        return real(q, k, v, *rest, **kw)
    monkeypatch.setattr(lightglue, "flash_attention", spy)
    return seen


def test_flash_selfblock_hands_g_its_v_packed_q_and_k_in_place(monkeypatch):
    """SelfBlock under "flash" (kernel G): the rotated q and k are read in
    place; v, the stride-3 view, is packed from its slab at phase 2."""
    seen = _capture_flash(monkeypatch)
    _self_block_step("flash", torch.Generator().manual_seed(3), False)
    assert len(seen) == 1
    for name in ("q", "k"):
        assert operand_plan(seen[0][name]).mode == "direct", name
    _assert_wqkv_v(seen[0]["v"], N1)


def test_flash_crossblock_hands_g_head_views_in_place(monkeypatch):
    """CrossBlock under "flash": both passes of G read the pre-scaled head
    views in place; no pack pass."""
    seen = _capture_flash(monkeypatch)
    _cross_block_step("flash", torch.Generator().manual_seed(4), False)
    assert len(seen) == 2
    for ops in seen:
        for name, t in ops.items():
            plan = operand_plan(t)
            assert plan.mode == "direct" and plan.ptr == t.data_ptr(), name
            assert plan.strides[1:] == (D, EMBED), name
