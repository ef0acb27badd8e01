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


@pytest.mark.parametrize("kind,want", [("fwd", 0.0521), ("bwd", 0.1302)])
def test_float32_fused_bounds_at_the_3xtf32_peak(cs, kind, want):
    """Float32 D and F run 3xTF32 products on the tensor cores and are
    held to that peak (495 / 3 TFLOP/s): D 4BhNMd, F 10BhNMd operations."""
    q = torch.empty(SHAPE, dtype=torch.float32)
    ms, by = cs.fused_bound_ms(kind, q, q, cs.PEAK_TF32X3_FLOPS)
    assert by == "operations" and round(ms, 4) == want


def _trace(calls, kernels=("k1", "k2"), launched=None):
    """Profiler events of `calls` calls that each launch `kernels`: their
    launch calls on the host and, where `launched` says which, the kernels
    on the device."""
    events = []
    for i in range(calls):
        for j, name in enumerate(kernels):
            events.append(("cudaLaunchKernel", False, 0.0))
            if launched is None or launched(i, j):
                events.append((name, True, 5.0))
    return events


def test_trace_gaps_accepts_a_whole_trace(cs):
    events = _trace(20) + [("Memcpy DtoD", True, 1.0),
                           ("aten::mm", False, 0.0)]
    assert cs.trace_gaps(events) == []


@pytest.mark.parametrize("lost", ["one kernel", "whole calls", "the last"])
def test_trace_gaps_finds_lost_kernel_events(cs, lost):
    """A trace whose kernels fall short of its launch calls is found short:
    one kernel's events lost now and then, whole calls' events lost (each
    kernel still seen equally often), or the trace's last kernel alone."""
    launched = {"one kernel": lambda i, j: j == 0 or i % 3,
                "whole calls": lambda i, j: i >= 10,
                "the last": lambda i, j: (i, j) != (19, 1)}[lost]
    gaps = cs.trace_gaps(_trace(20, launched=launched))
    assert any("launches" in g for g in gaps)


@pytest.mark.parametrize("short", [0, 1, 2, 3])
def test_device_ms_reads_only_a_whole_trace(cs, monkeypatch, short):
    """`device_ms` takes a short trace again, reads the first whole one,
    and fails once all of its three traces are short."""
    traces = [_trace(4, launched=lambda i, j: i)] * short + [_trace(4)]
    calls = []

    def trace_events(fn, iters):
        calls.append(iters)
        return traces[len(calls) - 1]

    monkeypatch.setattr(cs, "trace_events", trace_events)
    if short == 3:
        with pytest.raises(RuntimeError, match="3 traces lost events"):
            cs.device_ms(lambda: None, iters=4)
        assert len(calls) == 3
        return
    assert cs.device_ms(lambda: None, iters=4) == pytest.approx(
        {"k1": 5.0 / 1e3, "k2": 5.0 / 1e3})
    assert len(calls) == short + 1


@pytest.mark.parametrize("helper,kind,tokens,want", [
    ("attention_bound_ms", "self", 1024, 0.0521),
    ("flash_bound_ms", None, 1024, 0.0521),
    ("flash_bound_ms", None, 2048, 0.2082)])
def test_float32_e_and_g_bounds_at_the_3xtf32_peak(cs, helper, kind, tokens,
                                                   want):
    """Float32 E and G run the 3xTF32 loop and are held to its peak (495 /
    3 TFLOP/s): 4BhNMd operations, 0.0521 ms at the flagship's 1024
    tokens, G 0.2082 ms at 2048."""
    q = torch.empty(8, 4, tokens, 64, dtype=torch.float32)
    args = (q, q) if kind is None else (kind, q, q)
    ms, by = getattr(cs, helper)(*args, cs.PEAK_TF32X3_FLOPS)
    assert by == "operations" and round(ms, 4) == want
