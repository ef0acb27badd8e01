"""The bounds `chip_smoke.py` writes beside each attention kernel's time,
on CPU tensors at the flagship's (8, 4, 1024, 64): the operations of
each kernel over the card's peak for the operand type (989 TFLOP/s for
bfloat16 on the tensor cores, 67 TFLOP/s for float32 on the CUDA cores;
every case here is bound by operations, not bytes). F's float32 bound,
10BhNMd / 67 TFLOP/s, is 0.32 ms; its bfloat16 bound 0.0217 ms."""

import pytest
import torch
from tests.test_torch_threads import one_torch_thread  # noqa: F401

SHAPE = (8, 4, 1024, 64)
OPS = 8 * 4 * 1024 * 1024 * 64  # BhNMd


@pytest.fixture(scope="module")
def cs():
    import chip_smoke
    return chip_smoke


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("helper,kind,products", [
    ("attention_bound_ms", "self", 4), ("attention_bound_ms", "cross", 6),
    ("fused_bound_ms", "fwd", 4), ("fused_bound_ms", "bwd", 10),
    ("flash_bound_ms", None, 4)])
def test_attention_bounds_follow_the_dtype(cs, helper, kind, products,
                                           dtype):
    q = torch.empty(SHAPE, dtype=dtype)
    args = (q, q) if kind is None else (kind, q, q)
    ms, by = getattr(cs, helper)(*args)
    peak = 989e12 if dtype == torch.bfloat16 else 67e12
    assert by == "operations"
    assert ms == pytest.approx(products * OPS / peak * 1e3, rel=1e-12)


@pytest.mark.parametrize("dtype,want", [(torch.float32, 0.32),
                                        (torch.bfloat16, 0.0217)])
def test_f_bound(cs, dtype, want):
    q = torch.empty(SHAPE, dtype=dtype)
    ms, _ = cs.fused_bound_ms("bwd", q, q)
    assert round(ms, 2 if dtype == torch.float32 else 4) == want
