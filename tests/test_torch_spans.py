"""The program's spans (`utils/profiling.py:annotate`) and what is read from
them (`SpanTrace`): free while no profiler records, emitted and nested
as named under one, and invisible to the benchmark's accepted readings."""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ei_nexus_tpu_torch.utils import profiling
from ei_nexus_tpu_torch.utils.profiling import SpanTrace, annotate

FORWARD_SPANS = ("ei.extract.event", "ei.extract.image", "ei.extract.nms",
                 "ei.extract.topk", "ei.extract.describe", "ei.match")
LIGHTGLUE_SPANS = ("ei.match.self", "ei.match.cross", "ei.match.assign",
                   "ei.match.filter")
STEP_SPANS = ("ei.repr", "ei.train.gt", "ei.train.loss",
              "ei.train.backward", "ei.train.optim")
# (span, the span it lies in)
NESTING = (("ei.extract.nms", "ei.extract.event"),
           ("ei.extract.topk", "ei.extract.event"),
           ("ei.extract.describe", "ei.extract.event"),
           ("ei.extract.nms", "ei.extract.image"),
           ("ei.match.self", "ei.match"), ("ei.match.cross", "ei.match"),
           ("ei.match.assign", "ei.match"), ("ei.match.filter", "ei.match"))


def _tiny_eim(matcher: str, training_heads: bool = False):
    from ei_nexus_tpu_torch.flagship import init_parameters, stage2_config
    from ei_nexus_tpu_torch.models.eim import EIM
    cfg, shape = stage2_config(tiny=True, dtype="float32")
    if matcher == "MNN":
        cfg = dataclasses.replace(cfg, matcher=dataclasses.replace(
            cfg.matcher, type="MNN"))
    model = EIM(cfg, training_heads)
    init_parameters(model, torch.Generator().manual_seed(0))
    return model, shape


def _forward(model, shape):
    from ei_nexus_tpu_torch.data.synth import bursty_event_batch
    from ei_nexus_tpu_torch.train.steps import batch_representation
    H, W, bins = shape
    rng = np.random.default_rng(0)
    ev = bursty_event_batch(rng, 2, 3000, 4096, H, W)
    image = torch.as_tensor(rng.uniform(0, 255, (2, H, W, 1))
                            .astype(np.float32))
    with torch.no_grad():
        rep, mask = batch_representation(ev, "VoxelGrid", bins, H, W,
                                         device="cpu")
        return model.eval()(rep, image, mask)


def _spans(prof):
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events() if e.name.startswith("ei.")]


def _check_nesting(spans, pairs):
    for inner, outer in pairs:
        outers = [(t0, t1) for n, t0, t1 in spans if n == outer]
        for n, t0, t1 in spans:
            if n == inner and outers and any(o0 <= t0 and t1 <= o1
                                             for o0, o1 in outers):
                break
        else:
            raise AssertionError(f"no {inner} inside {outer}")


def test_annotate_is_free_without_a_profiler(monkeypatch):
    """With no profiler recording, every span is one shared no-op, and a
    whole forward opens no `record_function`."""
    assert annotate("ei.match") is annotate("ei.repr")
    with annotate("ei.match") as inner:
        assert inner is None
    opened = []
    real = torch.profiler.record_function

    def counted(*args, **kw):
        opened.append(args)
        return real(*args, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", counted)
    model, shape = _tiny_eim("LightGlue")
    _, _, m = _forward(model, shape)
    assert m["matches0"].shape[0] == 2
    assert opened == []
    with profile(activities=[ProfilerActivity.CPU]):
        with annotate("ei.repr"):
            pass
    assert opened == [("ei.repr",)]


@pytest.mark.parametrize("matcher", ["LightGlue", "MNN"])
def test_forward_emits_its_spans_nested(matcher):
    model, shape = _tiny_eim(matcher)
    _forward(model, shape)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _forward(model, shape)
    spans = _spans(prof)
    names = {n for n, _, _ in spans}
    want = FORWARD_SPANS + ("ei.repr",) + (
        LIGHTGLUE_SPANS if matcher == "LightGlue" else ())
    assert set(want) <= names, set(want) - names
    if matcher == "MNN":
        assert not names & set(LIGHTGLUE_SPANS)
    _check_nesting(spans, [p for p in NESTING if p[0] in names])
    count = {n: sum(1 for s in spans if s[0] == n) for n in names}
    assert count["ei.extract.nms"] == count["ei.extract.topk"] == 2
    if matcher == "LightGlue":
        # 2 layers: two self-attention calls and one cross a layer
        assert count["ei.match.self"] == 4 and count["ei.match.cross"] == 2


def test_image_image_matcher_spans():
    """`ImageImageMatcher` runs its one extractor under
    `ei.extract.image`, once a frame."""
    from ei_nexus_tpu_torch.flagship import init_parameters, stage2_config
    from ei_nexus_tpu_torch.models.eim import ImageImageMatcher
    cfg, (H, W, _) = stage2_config(tiny=True, dtype="float32")
    model = ImageImageMatcher(cfg).eval()
    init_parameters(model, torch.Generator().manual_seed(0))
    image = torch.rand(1, H, W, 1) * 255
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        model(image, torch.roll(image, 2, dims=2))
    spans = _spans(prof)
    assert sum(1 for s in spans if s[0] == "ei.extract.image") == 2
    assert not any(s[0] == "ei.extract.event" for s in spans)
    _check_nesting(spans, [("ei.extract.nms", "ei.extract.image"),
                           ("ei.match.self", "ei.match")])


def test_stage2_step_emits_its_spans():
    from ei_nexus_tpu_torch.data.synth import stage2_batch
    from ei_nexus_tpu_torch.flagship import stage2_train_state
    from ei_nexus_tpu_torch.train.steps import make_stage2_train_step
    model, (H, W, bins) = _tiny_eim("LightGlue", training_heads=True)
    state = stage2_train_state(model)
    batch = stage2_batch(np.random.default_rng(0), 2, 3000, 4096, H, W,
                         focal=61.0)
    step = make_stage2_train_step("VoxelGrid", bins, H, W)
    gen = torch.Generator()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        info = step(state, batch, gen.manual_seed(1))
    assert torch.isfinite(info["loss"])
    spans = _spans(prof)
    names = {n for n, _, _ in spans}
    want = STEP_SPANS + FORWARD_SPANS + LIGHTGLUE_SPANS
    assert set(want) <= names, set(want) - names
    _check_nesting(spans, NESTING)
    # the step's parts follow one another: forward, gt, loss, backward,
    # optimizer
    first = {n: min(t0 for m, t0, _ in spans if m == n) for n in names}
    order = ("ei.repr", "ei.match", "ei.train.gt", "ei.train.loss",
             "ei.train.backward", "ei.train.optim")
    assert [first[n] for n in order] == sorted(first[n] for n in order)


# a synthetic trace: two served batches, each with the harness's ranges
# and the program's spans, each kernel with the id of the call that
# launched it
CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def _ev(name, t0, t1, device=False, id=0, note=False, dev_us=0.0):
    return SimpleNamespace(
        name=name, time_range=SimpleNamespace(start=t0, end=t1),
        device_type=CUDA if device else CPU, id=id,
        is_user_annotation=note, device_time_total=dev_us)


def _batch(t, k):
    """One batch's events from host time `t`: (the harness's and the
    operators' events, the program's spans and their device-side
    annotations). Ids are unique over batches by `k`."""
    i = 100 * k
    base = [
        _ev("portbench.submit", t, t + 200, id=i + 1),
        _ev("portbench.repr", t + 5, t + 20, id=i + 2, dev_us=10.0),
        _ev("aten::index_add_", t + 8, t + 9, id=i + 3),
        _ev("cudaLaunchKernel", t + 8.2, t + 8.4, id=i + 50),
        _ev("indexFuncLargeIndex", t + 30, t + 40, True, i + 50),
        _ev("portbench.extract.event", t + 20, t + 60, id=i + 4, dev_us=5.0),
        _ev("cuLaunchKernel", t + 26, t + 27, id=i + 51),
        _ev("ei::nms_kernel", t + 40, t + 42, True, i + 51),
        _ev("aten::sort", t + 31, t + 32, id=i + 5),
        _ev("cudaLaunchKernel", t + 31.2, t + 31.4, id=i + 52),
        _ev("sort_kernel", t + 42, t + 45, True, i + 52),
        _ev("cudaStreamSynchronize", t + 33, t + 39, id=i + 53),
        _ev("portbench.extract.image", t + 60, t + 61, id=i + 6, dev_us=0.0),
        _ev("portbench.match", t + 61, t + 190, id=i + 7, dev_us=82.0),
        _ev("aten::mm", t + 62, t + 63, id=i + 8),
        _ev("cudaLaunchKernel", t + 62.2, t + 62.4, id=i + 54),
        _ev("ei::self_attention_tf32_kernel", t + 50, t + 70, True, i + 54),
        _ev("aten::add", t + 64, t + 130, id=i + 9),
        _ev("cudaLaunchKernel", t + 65, t + 125, id=i + 55),
        _ev("elementwise_kernel", t + 135, t + 137, True, i + 55),
        _ev("portbench.wait", t + 190, t + 200, id=i + 10),
        # a copy with no link: its gap is labelled by its middle
        _ev("Memcpy HtoD (Pinned -> Device)", t + 180, t + 181, True),
        _ev("cudaMemcpyAsync", t + 2, t + 3, id=i + 56),
        _ev("ProfilerStep#1", t, t + 200, id=i + 11),
    ]
    spans = [
        _ev("ei.repr", t + 6, t + 19, id=i + 13),
        _ev("ei.extract.event", t + 21, t + 59, id=i + 14),
        _ev("ei.extract.nms", t + 25, t + 30, id=i + 12),
        _ev("ei.extract.topk", t + 30, t + 40, id=i + 15),
        _ev("ei.extract.describe", t + 40, t + 45, id=i + 16),
        _ev("ei.match", t + 61.5, t + 140, id=i + 17),
        _ev("ei.match.self", t + 61.8, t + 63.5, id=i + 18),
        # the profiler's device-side copies of the spans
        _ev("ei.extract.nms", t + 40, t + 42, True, i + 60, note=True),
        _ev("ei.match", t + 50, t + 137, True, i + 61, note=True),
    ]
    return base, spans


def _events(with_spans: bool):
    out = []
    for k in range(2):
        base, spans = _batch(1000.0 * k, k)
        out += base + (spans if with_spans else [])
    return out


def test_span_trace_readings():
    """The three readings of the program's spans, a batch: launches,
    host time in waiting calls (by call and by span), and the device
    time of keypoint selection."""
    tr = SpanTrace(_events(True))
    assert tr.launches() == 2 * 5
    by_call, by_span = tr.waiting()
    assert by_call == {"cudaStreamSynchronize": 2 * 6.0,
                       "cudaLaunchKernel": 2 * 60.0}
    assert by_span == {"ei.extract.topk": 2 * 6.0, "ei.match": 2 * 60.0}
    assert tr.device_us(("ei.extract.nms", "ei.extract.topk")) == 2 * 5.0
    assert tr.call_us() == {
        "cudaLaunchKernel": (2 * 4, pytest.approx(2 * 60.6)),
        "cuLaunchKernel": (2, 2 * 1.0), "cudaStreamSynchronize": (2, 2 * 6.0)}
    # the device-side annotations are no operations
    assert not any(n.startswith("ei.") for n, *_ in tr.ops)
    assert len(tr.ops) == 2 * 6
    rows = tr.table()
    assert rows["ei.match"]["launches"] == 2 * 2
    assert rows["ei.match.self"]["self_launches"] == 2
    assert rows["ei.match"]["self_launches"] == 2
    assert rows["ei.match"]["device_us"] == 2 * (20.0 + 2.0)
    assert rows["ei.match"]["self_device_us"] == 2 * 2.0
    assert rows["ei.extract.event"]["device_us"] == 2 * 5.0
    assert rows["ei.extract.event"]["wait_us"] == 2 * 6.0
    assert rows["ei.repr"]["count"] == 2
    # nothing outside a span counts: the copy's call is in no span
    assert SpanTrace(_events(False)).launches() == 0


def test_span_trace_kernel_by_span():
    """A kernel's launches and device time by the spans that launched it
    (tools/trace_spans.py reads kernel L's so): the attention kernel of the
    synthetic batch is launched in `ei.match.self`, inside `ei.match`."""
    tr = SpanTrace(_events(True))
    frag = "self_attention_tf32_kernel"
    assert tr.kernel_us(frag, ("ei.match.self",)) == (2, 2 * 20.0)
    assert tr.kernel_us(frag, ("ei.match",)) == (2, 2 * 20.0)
    assert tr.kernel_us(frag, ("ei.match.cross", "ei.repr")) == (0, 0.0)
    assert tr.kernel_us("linear_tf32_kernel", ("ei.match",)) == (0, 0.0)
    assert tr.kernel_us("nms_kernel", ("ei.extract.nms",)) == (2, 2 * 2.0)


def test_span_trace_gap_labels_and_union():
    """Each idle gap takes the innermost span that held the launch of the
    operation ending it (the program's or the harness's), or, with no
    link, the span at its middle; the busy union is the benchmark's."""
    from portbench.harness.trace import Trace
    events = _events(True)
    tr = SpanTrace(events, prefixes=("ei.", "portbench."))
    ref = Trace(events, 2)
    assert tr.busy_us == pytest.approx(ref.busy_us)
    assert tr.idle == pytest.approx(ref.idle)
    got = sorted((round(us, 6), name) for name, us in tr.gap_labels(100))
    # a batch: the attention kernel's gap (launched in ei.match.self),
    # the long launch's (ei.match), the unlinked copy's (its middle lies
    # in the harness's match range only); then the second batch's first
    # kernel, launched in ei.repr, ends the gap after the first batch
    want = 2 * [(5.0, "ei.match.self"), (65.0, "ei.match"),
                (43.0, "portbench.match")] + [(1030.0 - 181.0, "ei.repr")]
    assert got == sorted(want)
    # the program's spans alone: the copy's gap lies outside them
    only = dict(SpanTrace(events).gap_labels(n=100))
    assert only.get("outside the spans") == 43.0


def test_benchmark_readings_ignore_the_program_spans():
    """The accepted benchmark's seven per-layer readings and its
    breakdown's device operations are the same on one trace with and
    without the program's spans."""
    from portbench.harness import common
    from portbench.harness.trace import Trace
    names = ("host_ms.serve", "repr_dev_ms.serve", "extract_dev_ms.serve",
             "match_dev_ms.serve", "attn_roofline.serve", "mfu.serve",
             "device_idle.serve")
    shape = {"B": 16, "h": 4, "N": 1024, "M": 1024, "d": 64, "D": 256,
             "layers": 9}
    got = {}
    for with_spans in (False, True):
        trace = Trace(_events(with_spans), 2)
        ctx = {"role": "serve", "shape": shape, "flops_per_batch": 1e12,
               "window_batches": 10, "window_s": 0.01,
               "host_s": [0.07, 0.075], "pairs_per_batch": 16,
               "trace": trace}
        got[with_spans] = ({n: common.metric_reader(n)(ctx) for n in names},
                           trace.breakdown()["device_ops"], trace.busy_us,
                           trace.window_us)
    assert all(v is not None for v in got[False][0].values())
    assert got[True] == got[False]


def test_waits_rule():
    assert profiling.waits("cudaStreamSynchronize", 1.0)
    assert profiling.waits("cudaDeviceSynchronize", 1.0)
    assert profiling.waits("cudaMemcpy", 1.0)
    assert not profiling.waits("cudaMemcpyAsync", 500.0)
    assert profiling.waits("cudaLaunchKernel", 51.0)
    assert not profiling.waits("cudaLaunchKernel", 49.0)
