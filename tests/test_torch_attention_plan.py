"""The operand plan of the Hopper loop of kernels A and E
(`ops/attention_kernels.py:operand_plan`) on CPU tensors: which operands
TMA reads in place, which the pack pass writes first (with the slab and
phase it reads them from), and which neither takes. The plan looks only at
shapes, strides and addresses, so CPU tensors stand for the card's."""

import pytest
import torch

from ei_nexus_tpu_torch.ops.attention_kernels import operand_plan

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
