#!/usr/bin/env python
"""Smoke run of the PyTorch/CUDA port (`ei_nexus_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure:
 1. setup: a CUDA device is required; the kernels are built from
    `ei_nexus_tpu_torch/csrc` (one nvcc per source, all at once); TF32 is
    switched off for matmuls and convolutions so float32 comparisons are
    float32; the card's name and power limit are printed;
 2. every kernel of the two paths below against its plain PyTorch version
    at the paths' shapes, in float32 and bfloat16, timed with CUDA events
    beside the plain version, the library call that computes the same
    function (SDPA for the attention kernels: forward for A, B, D; SDPA's
    backward, (forward + backward) - forward, for F) and the card's bound;
    F's gradients are also held to a relative norm, which planted faults
    (c = 0, c or the log-sum-exp of the neighbouring row) must break;
 3. the flagship EIM forward at full width (260x346, 16 bins, K=1024,
    9 LightGlue layers of 4x64, bfloat16, B=8) on bursty events, with the
    kernels' launch counts read around one forward, then timed one forward
    at a time (latency) and back to back (throughput, the pairs/s line);
 4. the stage-2 training step at full width (the same model with both
    extractors frozen and LightGlue trained, AdamW, B=8): launch counts
    read around one step (D and F 36 each, C 2, A and B none), finite loss,
    grad_norm > 0, frozen parameters and BatchNorm statistics bit-unchanged,
    matcher parameters changed, the loss lower after 10 steps on the same
    batch and fill, then steps/s over 24 steps back to back with the spread
    of single steps, and peak memory;
 5. one small float32 model on the CPU (plain versions) and on the card
    (kernels), same weights and inputs: the inference forward and one
    stage-2 step (same batch and fill), agreement bounded.

Prints the kernels' JSON line (launches: A, B, C from phase 3's forward;
D, F from phase 4's step), the card's `nvidia-smi` line, the forward and
step rates, and as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits non-zero without a card. Writes the nvcc/ptxas log to
chiprun_out/chip_smoke_build.log.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

# H100 SXM data-sheet peaks (dense): the bound of each kernel is the larger
# of its bytes over the memory rate and its operations over the peak rate
# of their type.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12        # CUDA cores, no tensor cores
PEAK_BYTES = 3.35e12

MAIN_B, MAIN_H, MAIN_N, MAIN_D = 8, 4, 1024, 64   # LightGlue attention
# kernel F's gradients are far below 1 (|dq| ~ 0.06 at the flagship), so
# beside the max|err| bound each is held to a relative norm: bfloat16's
# rounding of the outputs alone gives ~2e-3, a dropped or misread c ~6e-2
BWD_REL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
NMS_SHAPE, NMS_RADIUS, NMS_ROUNDS = (8, 264, 352), 4, 4


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call over `iters` calls, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b|| over the whole tensor."""
    return float((a.float() - b.float()).norm() / b.float().norm())


def require(ok, what: str) -> None:
    """A phase's check: raises (also under python -O) when it fails."""
    if not ok:
        raise AssertionError(what)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def _heads(x: torch.Tensor, h: int) -> torch.Tensor:
    """(B, N, h*d) -> (B, h, N, d) strided view, as the LightGlue blocks
    split heads."""
    return x.unflatten(-1, (h, -1)).transpose(1, 2)


def attention_inputs(dtype, gen):
    """Main-path shaped operands: kernel A reads q/k/v as the (B, N, h, d, 3)
    stride-3 views of a Wqkv output; kernel B reads pre-scaled head views."""
    B, h, N, d = MAIN_B, MAIN_H, MAIN_N, MAIN_D
    dev = "cuda"

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    qkv = randn(B, N, h * d * 3).to(dtype).unflatten(
        -1, (h, d, 3)).transpose(1, 2)
    q, k, v = qkv[..., 0], qkv[..., 1], qkv[..., 2]
    ang = torch.rand(B, N, d // 2, generator=gen, device=dev) * 2 * np.pi
    cos = torch.repeat_interleave(torch.cos(ang), 2, -1).to(dtype)
    sin = torch.repeat_interleave(torch.sin(ang), 2, -1).to(dtype)
    mask0 = torch.rand(B, N, generator=gen, device=dev) > 0.2
    mask1 = torch.rand(B, N, generator=gen, device=dev) > 0.2
    s = d ** -0.25
    qk0 = _heads(randn(B, N, h * d).to(dtype), h) * s
    qk1 = _heads(randn(B, N, h * d).to(dtype), h) * s
    v0 = _heads(randn(B, N, h * d).to(dtype), h)
    v1 = _heads(randn(B, N, h * d).to(dtype), h)
    return dict(q=q, k=k, v=v, rot=(cos, sin), mask0=mask0, mask1=mask1,
                qk0=qk0, qk1=qk1, v0=v0, v1=v1)


def _bound(ops: float, peak: float, nbytes: float) -> tuple:
    t_ops = ops / peak * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def attention_bound_ms(kind: str, q: torch.Tensor, k: torch.Tensor) -> tuple:
    """Bound of one bf16 call on (B, h, N, d) queries and (B, h, M, d)
    keys: each input read once (q, k, v, the rotary tables, the float32
    biases), each output written once."""
    B, h, N, d = q.shape
    M = k.shape[2]
    es = q.element_size()
    if kind == "self":
        flops = 4.0 * B * h * N * M * d           # QK^T and PV
        nbytes = (4 * B * h * N * d + 2 * B * N * d) * es + B * M * 4
    else:
        flops = 6.0 * B * h * N * M * d           # S once, two PV products
        nbytes = 3 * B * h * (N + M) * d * es + B * (N + M) * 4
    return _bound(flops, PEAK_BF16_FLOPS, nbytes)


def nms_bound_ms(score: torch.Tensor) -> tuple:
    """Bound of one call: the map read once and written once; per pixel and
    round two separable (2r+1)^2 window maxima (pooling and dilation, 4*2r
    max ops) plus the compares and the select (~5)."""
    nbytes = 2 * score.numel() * score.element_size()
    ops = score.numel() * NMS_ROUNDS * (8 * NMS_RADIUS + 5)
    return _bound(ops, PEAK_F32_FLOPS, nbytes)


def fused_bound_ms(kind: str, q: torch.Tensor, k: torch.Tensor) -> tuple:
    """Bound of one bf16 call of kernel D ("fwd") or F ("bwd") on
    (B, h, N, d) queries and (B, h, M, d) keys. D: QK^T and PV (4BhNMd
    operations); reads q, k, v and the float32 bias, writes the output and
    the float32 log-sum-exp. F: the five products of the TPU backward
    (10BhNMd); reads q, k, v, the output, dO, the bias and the log-sum-exp,
    writes dq, dk, dv."""
    B, h, N, d = q.shape
    M = k.shape[2]
    es = q.element_size()
    if kind == "fwd":
        flops = 4.0 * B * h * N * M * d
        nbytes = (2 * N + 2 * M) * B * h * d * es + B * M * 4 + B * h * N * 4
    else:
        flops = 10.0 * B * h * N * M * d
        nbytes = ((4 * N + 4 * M) * B * h * d * es + B * M * 4
                  + B * h * N * 4)
    return _bound(flops, PEAK_BF16_FLOPS, nbytes)


def fused_cases(x):
    """Kernel D/F operands as the training path gives them: self-attention
    q, k after the rotary (applied outside) and v the stride-3 view, scale
    d^-0.5; cross-attention the pre-scaled head views, scale 1."""
    from ei_nexus_tpu_torch.ops import attention_kernels as ak
    cos, sin = (t[:, None] for t in x["rot"])

    def rot(t):
        return t * cos + ak.rotate_half(t) * sin
    return {"self": (rot(x["q"]), rot(x["k"]), x["v"], x["mask0"],
                     MAIN_D ** -0.5),
            "cross": (x["qk0"], x["qk1"], x["v1"], x["mask1"], 1.0)}


def check_fused(x, dtype, tol, gen):
    """Kernels D and F against their plain versions on both cases, and
    planted faults of F (c = 0, c or the log-sum-exp of the neighbouring
    row) that F's relative-norm check must catch; returns the largest
    errors (D, F), the self case's tensors for timing and F's largest
    relative norm."""
    from ei_nexus_tpu_torch.ops import attention_kernels as ak
    err_d = err_f = rel_f = 0.0
    caught = float("inf")
    for case, (q, k, v, mask, scale) in fused_cases(x).items():
        B, h, N, d = q.shape
        bias = ak.key_bias(mask, B, k.shape[2], "cuda")
        out, lse = ak.attention_fwd(q, k, v, bias, scale)
        want = ak.fused_attention_plain(q, k, v, mask, scale)
        torch.cuda.synchronize()
        e = max_err(out, want)
        require(e <= tol * max(1.0, float(want.float().abs().max())),
                f"attention_fwd ({case}) disagrees in {dtype}: {e:.3e}")
        err_d = max(err_d, e)
        # dO as autograd hands it: a (B, h, N, d) view of (B, N, h, d)
        do = torch.randn(B, N, h, d, generator=gen, device="cuda").to(
            dtype).permute(0, 2, 1, 3)
        got = ak.attention_bwd(q, k, v, out, do, bias, lse, scale)
        want = ak.fused_attention_bwd_plain(q, k, v, bias, do, scale)
        torch.cuda.synchronize()
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            e, r = max_err(a, b), rel_err(a, b)
            bound = tol * max(1.0, float(b.float().abs().max()))
            require(e <= bound, f"attention_bwd {name} ({case}) disagrees "
                                f"in {dtype}: {e:.3e} > {bound:.3e}")
            require(r <= BWD_REL[dtype],
                    f"attention_bwd {name} ({case}) disagrees in {dtype}: "
                    f"relative norm {r:.3e} > {BWD_REL[dtype]:g}")
            err_f, rel_f = max(err_f, e), max(rel_f, r)
        # F reads c = rowsum(dO o O) from the output: a zero output plants
        # c = 0, a rolled one the neighbouring row's c
        for o, l in ((torch.zeros_like(out), lse), (out.roll(1, 2), lse),
                     (out, lse.roll(1, 2))):
            bad = ak.attention_bwd(q, k, v, o, do, bias, l, scale)
            caught = min(caught, max(rel_err(a, b)
                                     for a, b in zip(bad, want)))
        if case == "self":
            kept = (q, k, v, mask, scale, bias, out, lse, do)
    torch.cuda.synchronize()
    require(caught > 5 * BWD_REL[dtype],
            f"a planted fault of attention_bwd moves the relative norm only "
            f"{caught:.3e} in {dtype}")
    print(f"[kernels] {dtype}: attention_fwd max|err| {err_d:.3e}, "
          f"attention_bwd max|err| {err_f:.3e} (tol {tol:g} x max(1, "
          f"max|ref|)), relative norm {rel_f:.3e} (tol {BWD_REL[dtype]:g}; "
          f"planted faults: {caught:.3e} or more), self and cross, key-side "
          f"masks")
    return err_d, err_f, kept, rel_f


def phase_kernels():
    from ei_nexus_tpu_torch.ops import attention_kernels as ak
    from ei_nexus_tpu_torch.ops import nms_kernel as nk

    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = {}
    fused_errs = {}
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        x = attention_inputs(dtype, gen)
        got = ak.self_attention(x["q"], x["k"], x["v"], x["mask0"],
                                rot=x["rot"])
        want = ak.self_attention_plain(x["q"], x["k"], x["v"], x["mask0"],
                                       rot=x["rot"])
        torch.cuda.synchronize()
        e_a = max_err(got, want)
        g0, g1 = ak.cross_attention_bidir(x["qk0"], x["qk1"], x["v0"],
                                          x["v1"], x["mask0"], x["mask1"])
        w0, w1 = ak.cross_attention_bidir_plain(
            x["qk0"], x["qk1"], x["v0"], x["v1"], x["mask0"], x["mask1"])
        torch.cuda.synchronize()
        e_b = max(max_err(g0, w0), max_err(g1, w1))
        print(f"[kernels] {dtype}: self_attention max|err| {e_a:.3e}, "
              f"cross_attention_bidir max|err| {e_b:.3e} (tol {tol:g}, "
              f"all rows, key-side masks)")
        require(e_a <= tol and e_b <= tol,
                f"attention kernel disagrees in {dtype}")
        errs[dtype] = (e_a, e_b)
        fused_errs[dtype] = check_fused(x, dtype, tol, gen)
    # bfloat16 (the main path's type) timings; x holds the bf16 operands
    t_a = cuda_ms(lambda: ak.self_attention(x["q"], x["k"], x["v"],
                                            x["mask0"], rot=x["rot"]))
    t_a_plain = cuda_ms(lambda: ak.self_attention_plain(
        x["q"], x["k"], x["v"], x["mask0"], rot=x["rot"]), iters=5)
    # SDPA's yardstick gets the rotary applied beforehand and contiguous
    # operands (its fused paths want a unit stride on d), outside the timing
    qr, kr = (
        (t * x["rot"][0][:, None] + ak.rotate_half(t) * x["rot"][1][:, None])
        .contiguous() for t in (x["q"], x["k"]))
    vc = x["v"].contiguous()
    am0 = x["mask0"][:, None, None, :]
    am1 = x["mask1"][:, None, None, :]
    t_a_lib = cuda_ms(lambda: F.scaled_dot_product_attention(
        qr, kr, vc, attn_mask=am0))
    t_b = cuda_ms(lambda: ak.cross_attention_bidir(
        x["qk0"], x["qk1"], x["v0"], x["v1"], x["mask0"], x["mask1"]))
    t_b_plain = cuda_ms(lambda: ak.cross_attention_bidir_plain(
        x["qk0"], x["qk1"], x["v0"], x["v1"], x["mask0"], x["mask1"]),
        iters=5)

    def sdpa_bidir():
        F.scaled_dot_product_attention(x["qk0"], x["qk1"], x["v1"],
                                       attn_mask=am1, scale=1.0)
        F.scaled_dot_product_attention(x["qk1"], x["qk0"], x["v0"],
                                       attn_mask=am0, scale=1.0)
    t_b_lib = cuda_ms(sdpa_bidir)

    # D and F on the bf16 self-attention case
    q, k, v, mask, scale, bias, out, lse, do = fused_errs[torch.bfloat16][2]
    t_d = cuda_ms(lambda: ak.attention_fwd(q, k, v, bias, scale))
    t_d_plain = cuda_ms(lambda: ak.fused_attention_plain(q, k, v, mask,
                                                         scale), iters=5)
    t_f = cuda_ms(lambda: ak.attention_bwd(q, k, v, out, do, bias, lse,
                                           scale))
    t_f_plain = cuda_ms(lambda: ak.fused_attention_bwd_plain(
        q, k, v, bias, do, scale), iters=5)
    qg, kg, vg = (t.detach().contiguous().requires_grad_() for t in (q, k, v))
    dog = do.contiguous()
    am = mask[:, None, None, :]
    with torch.no_grad():
        t_d_lib = cuda_ms(lambda: F.scaled_dot_product_attention(
            qg, kg, vg, attn_mask=am, scale=scale))

    def sdpa_fwd():
        return F.scaled_dot_product_attention(qg, kg, vg, attn_mask=am,
                                              scale=scale)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa_fwd(), (qg, kg, vg), dog)
    t_f_lib = cuda_ms(sdpa_fwd_bwd) - cuda_ms(sdpa_fwd)

    score = torch.rand(*NMS_SHAPE, generator=gen, device="cuda")
    score = torch.where(score > 0.3, score, torch.zeros_like(score))
    got = nk.nms_rounds(score, NMS_RADIUS, NMS_ROUNDS)
    want = nk.nms_rounds_plain(score, NMS_RADIUS, NMS_ROUNDS)
    torch.cuda.synchronize()
    require(torch.equal(got, want),
            f"NMS kernel is not bit-exact: {int((got != want).sum())} "
            f"pixels differ")
    sb = score.to(torch.bfloat16)
    require(torch.equal(nk.nms_rounds(sb, NMS_RADIUS, NMS_ROUNDS),
                        nk.nms_rounds_plain(sb, NMS_RADIUS, NMS_ROUNDS)),
            "NMS kernel is not bit-exact in bfloat16")
    print("[kernels] nms_rounds: bit-exact in float32 and bfloat16")
    t_c = cuda_ms(lambda: nk.nms_rounds(score, NMS_RADIUS, NMS_ROUNDS))
    t_c_plain = cuda_ms(lambda: nk.nms_rounds_plain(score, NMS_RADIUS,
                                                    NMS_ROUNDS))

    b_a, by_a = attention_bound_ms("self", x["q"], x["k"])
    b_b, by_b = attention_bound_ms("cross", x["qk0"], x["qk1"])
    b_c, by_c = nms_bound_ms(score)
    b_d, by_d = fused_bound_ms("fwd", q, k)
    b_f, by_f = fused_bound_ms("bwd", q, k)
    rows = [
        dict(name="self_attention_rot", route="cuda",
             source="ei_nexus_tpu_torch/csrc/self_attention.cu",
             replaces="ei_nexus_tpu/ops/pallas_attention.py:289",
             max_abs_err=errs[torch.bfloat16][0],
             max_abs_err_f32=errs[torch.float32][0],
             ms=t_a, plain_ms=t_a_plain, bound_ms=b_a, bound_by=by_a,
             library_ms=t_a_lib),
        dict(name="cross_attention_bidir", route="cuda",
             source="ei_nexus_tpu_torch/csrc/cross_attention.cu",
             replaces="ei_nexus_tpu/ops/pallas_attention.py:187",
             max_abs_err=errs[torch.bfloat16][1],
             max_abs_err_f32=errs[torch.float32][1],
             ms=t_b, plain_ms=t_b_plain, bound_ms=b_b, bound_by=by_b,
             library_ms=t_b_lib),
        dict(name="nms_rounds", route="cuda",
             source="ei_nexus_tpu_torch/csrc/nms.cu",
             replaces="ei_nexus_tpu/ops/pallas_nms.py:57",
             max_abs_err=0.0, max_abs_err_f32=0.0,
             ms=t_c, plain_ms=t_c_plain, bound_ms=b_c, bound_by=by_c,
             library_ms=None),
        dict(name="attention_fwd", route="cuda",
             source="ei_nexus_tpu_torch/csrc/attention_fwd.cu",
             replaces="ei_nexus_tpu/ops/pallas_attention.py:274",
             max_abs_err=fused_errs[torch.bfloat16][0],
             max_abs_err_f32=fused_errs[torch.float32][0],
             ms=t_d, plain_ms=t_d_plain, bound_ms=b_d, bound_by=by_d,
             library_ms=t_d_lib),
        dict(name="attention_bwd", route="cuda",
             source="ei_nexus_tpu_torch/csrc/attention_bwd.cu",
             replaces="ei_nexus_tpu/ops/pallas_attention.py:349",
             max_abs_err=fused_errs[torch.bfloat16][1],
             max_abs_err_f32=fused_errs[torch.float32][1],
             rel_err=fused_errs[torch.bfloat16][3],
             rel_err_f32=fused_errs[torch.float32][3],
             ms=t_f, plain_ms=t_f_plain, bound_ms=b_f, bound_by=by_f,
             library_ms=t_f_lib),
    ]
    for r in rows:
        print(f"[kernels] {r['name']}: {r['ms']:.4f} ms (plain "
              f"{r['plain_ms']:.4f}, library {r['library_ms']}, bound "
              f"{r['bound_ms']:.4f} by {r['bound_by']})")
    return rows


# ---------------------------------------------------------------------------
# phase 3: the main path at full width
# ---------------------------------------------------------------------------


def phase_main_path():
    from ei_nexus_tpu_torch.data.synth import bursty_event_batch
    from ei_nexus_tpu_torch.flagship import build_flagship
    from ei_nexus_tpu_torch.train.steps import batch_representation

    B, max_events = 8, 1 << 17
    model, (H, W, bins) = build_flagship(
        dtype="bfloat16", generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    ev = bursty_event_batch(rng, B, int(max_events * 0.95), max_events, H, W)
    image = rng.uniform(0, 255, (B, H, W, 1)).astype(np.float32)
    ev = {k: torch.as_tensor(v).cuda() for k, v in ev.items()}
    image = torch.as_tensor(image).cuda()

    def forward():
        rep, mask = batch_representation(ev, "VoxelGrid", bins, H, W)
        return model(rep, image, mask)

    counters = kernel_counters()
    with torch.inference_mode():
        for c in counters.values():
            c.launches = 0
        f0, f1, m = forward()
        torch.cuda.synchronize()
        launches = {n: c.launches for n, c in counters.items()}
        print(f"[main] launches in one forward: {launches}")
        want = {"self_attention_rot": 18, "cross_attention_bidir": 9,
                "nms_rounds": 2, "attention_fwd": 0, "attention_bwd": 0}
        require(launches == want, f"launch counts {launches} != {want}")
        K = 1024
        for f in (f0, f1):
            require(f["sparse_positions"].shape == (B, K, 3)
                    and f["sparse_descriptors"].shape == (B, K, 256),
                    "keypoint or descriptor shape")
            require(torch.isfinite(f["sparse_positions"]).all()
                    and torch.isfinite(f["sparse_descriptors"]).all(),
                    "non-finite keypoints or descriptors")
        require(m["matches0"].shape == (B, K)
                and m["log_assignment"].shape == (B, K + 1, K + 1),
                "match shapes")
        require(torch.isfinite(m["matching_scores0"]).all(),
                "non-finite matching scores")
        n_valid = [int(f["sparse_valid"].sum()) for f in (f0, f1)]
        n_match = int((m["matches0"] > -1).sum())
        print(f"[main] valid keypoints {n_valid} of {B * K} per side, "
              f"{n_match} matches")
        require(n_match >= 1, "no valid match")

        torch.cuda.reset_peak_memory_stats()
        for _ in range(2):
            forward()
        # latency: one forward at a time, each ended by a synchronize
        samples = []
        for _ in range(10):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            forward()
            end.record()
            torch.cuda.synchronize()
            samples.append(start.elapsed_time(end))
        # throughput: forwards back to back, as a server runs them
        n = 10
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(n):
            forward()
        end.record()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / n
        per_fwd = start.elapsed_time(end) / n
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"[main] forward (voxelize + EIM) B={B}: latency median "
          f"{float(np.median(samples)):.3f} ms, max {max(samples):.3f} ms "
          f"over {len(samples)} synchronized forwards (CUDA events); back "
          f"to back {per_fwd:.3f} ms per forward over {n} (CUDA events; "
          f"host clock {host_ms:.3f} ms); peak memory {peak_gb:.2f} GB")
    return launches, per_fwd, B


# ---------------------------------------------------------------------------
# phase 4: the stage-2 training step at full width
# ---------------------------------------------------------------------------

# the counters of every kernel, by the name the JSON line gives it
def kernel_counters():
    from ei_nexus_tpu_torch.ops import attention_kernels as ak
    from ei_nexus_tpu_torch.ops import nms_kernel as nk
    return {"self_attention_rot": ak.self_attention,
            "cross_attention_bidir": ak.cross_attention_bidir,
            "nms_rounds": nk.nms_rounds,
            "attention_fwd": ak.attention_fwd,
            "attention_bwd": ak.attention_bwd}


def to_cuda(batch):
    """A stage-2 batch of numpy arrays -> the same structure on the card."""
    data0, data1, T01, T10 = batch
    dev = {k: torch.as_tensor(v).cuda() for k, v in data0.items()}
    return (dev, {k: torch.as_tensor(v).cuda() for k, v in data1.items()},
            torch.as_tensor(T01).cuda(), torch.as_tensor(T10).cuda())


def phase_stage2():
    from ei_nexus_tpu_torch.data.synth import stage2_batch
    from ei_nexus_tpu_torch.flagship import (build_stage2_flagship,
                                             stage2_train_state)
    from ei_nexus_tpu_torch.train.steps import make_stage2_train_step

    B, max_events = 8, 1 << 17
    model, (H, W, bins) = build_stage2_flagship(
        dtype="bfloat16", generator=torch.Generator().manual_seed(0))
    # 100 steps an epoch: the cosine schedule stays near its base lr here
    state = stage2_train_state(model, steps_per_epoch=100)
    batch = to_cuda(stage2_batch(np.random.default_rng(0), B,
                                 int(max_events * 0.95), max_events, H, W))
    step = make_stage2_train_step("VoxelGrid", bins, H, W)
    fill = torch.Generator(device="cuda")
    start = {k: v.clone() for k, v in model.state_dict().items()}

    counters = kernel_counters()
    for c in counters.values():
        c.launches = 0
    fill.manual_seed(1)
    info = step(state, batch, fill)
    torch.cuda.synchronize()
    launches = {n: c.launches for n, c in counters.items()}
    print(f"[stage2] launches in one step: {launches}")
    want = {"self_attention_rot": 0, "cross_attention_bidir": 0,
            "nms_rounds": 2, "attention_fwd": 36, "attention_bwd": 36}
    require(launches == want, f"launch counts {launches} != {want}")
    loss1, gnorm = float(info["loss"]), float(info["grad_norm"])
    require(np.isfinite(loss1) and np.isfinite(gnorm) and gnorm > 0,
            f"loss {loss1}, grad_norm {gnorm}")
    print(f"[stage2] step 1: loss {loss1:.6f}, grad_norm {gnorm:.6f}, "
          f"gt_matches {float(info['gt_matches']):.2f}")
    for _ in range(10):
        fill.manual_seed(1)     # the same batch and the same fill
        info = step(state, batch, fill)
    loss11 = float(info["loss"])
    print(f"[stage2] loss after 10 more updates on the same batch and "
          f"fill: {loss11:.6f} (step 1: {loss1:.6f})")
    require(loss11 < loss1, "the loss did not decrease")
    end = model.state_dict()
    frozen = [k for k in start if not k.startswith("matcher.")]
    changed = [k for k in frozen if not torch.equal(start[k], end[k])]
    require(not changed, f"frozen tensors changed: {changed[:5]}")
    n_stats = sum(k.endswith(("running_mean", "running_var")) for k in frozen)
    moved = sum(not torch.equal(start[k], end[k]) for k in start
                if k.startswith("matcher."))
    n_matcher = sum(k.startswith("matcher.") for k in start)
    print(f"[stage2] {len(frozen)} frozen tensors ({n_stats} BatchNorm "
          f"statistics) bit-unchanged; {moved} of {n_matcher} matcher "
          f"tensors changed")
    require(moved == n_matcher, "a matcher parameter did not change")

    # steps back to back, an event between each: the window's mean rate
    # and the spread of single steps inside it
    torch.cuda.reset_peak_memory_stats()
    n = 24
    events = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
    t0 = time.perf_counter()
    events[0].record()
    for i in range(n):
        fill.manual_seed(1)
        step(state, batch, fill)
        events[i + 1].record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / n
    each = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    per_step = events[0].elapsed_time(events[-1]) / n
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"[stage2] step B={B}: {per_step:.3f} ms per step back to back "
          f"over {n} (CUDA events; host clock {host_ms:.3f} ms), "
          f"{1e3 / per_step:.3f} steps/s; single steps min "
          f"{min(each):.3f}, median {float(np.median(each)):.3f}, max "
          f"{max(each):.3f} ms; peak memory {peak_gb:.2f} GB")
    return launches, per_step


# ---------------------------------------------------------------------------
# phase 5: the same small model on the CPU and on the card
# ---------------------------------------------------------------------------


def phase_cpu_vs_gpu():
    from ei_nexus_tpu_torch.data.synth import bursty_event_batch
    from ei_nexus_tpu_torch.flagship import flagship_config
    from ei_nexus_tpu_torch.models.eim import EIM
    from ei_nexus_tpu_torch.models.layers import init_parameters
    from ei_nexus_tpu_torch.train.steps import batch_representation

    H, W, bins, K, B = 64, 96, 4, 128, 2
    cfg, _ = flagship_config(tiny=False, dtype="float32")
    # fixed 4 NMS rounds on both devices (the CPU's "auto" runs to
    # convergence); heads of 64 as the kernels require
    kp = dataclasses.replace(cfg.event_extractor.keypoints,
                             detection_top_k=K, nms_impl="pallas")
    cfg = dataclasses.replace(
        cfg,
        event_extractor=dataclasses.replace(
            cfg.event_extractor, in_channels=bins, feat_channels=32,
            lat_channels=64, keypoints=kp),
        image_extractor=dataclasses.replace(cfg.image_extractor,
                                            keypoints=kp),
        matcher=dataclasses.replace(
            cfg.matcher, max_points_num=K,
            lightglue=dataclasses.replace(cfg.matcher.lightglue,
                                          n_layers=2)))
    cpu_model = EIM(cfg).eval()
    init_parameters(cpu_model, torch.Generator().manual_seed(1))
    gpu_model = copy.deepcopy(cpu_model).cuda()
    rng = np.random.default_rng(1)
    ev = bursty_event_batch(rng, B, 6000, 8192, H, W)
    image = torch.as_tensor(rng.uniform(0, 255, (B, H, W, 1)).astype(
        np.float32))
    outs = {}
    with torch.inference_mode():
        for name, model, dev in (("cpu", cpu_model, "cpu"),
                                 ("cuda", gpu_model, "cuda")):
            rep, mask = batch_representation(ev, "VoxelGrid", bins, H, W,
                                             device=dev)
            outs[name] = (rep.cpu(), mask.cpu()) + tuple(
                model(rep, image.to(dev), mask))
    (rc, mc, e_c, i_c, m_c), (rg, mg, e_g, i_g, m_g) = (
        outs["cpu"], outs["cuda"])
    # the card's scatter adds atomically in another order: voxels that
    # cancel to exactly 0 on one side may be ~1e-8 on the other
    zero_flip = int(((rc == 0) != (rg == 0)).sum())
    rep_err = max_err(rc, rg)
    print(f"[cpu-vs-gpu] voxel grid max|err| {rep_err:.2e}, "
          f"zero/nonzero flips {zero_flip} of {rc.numel()}, mask equal "
          f"{bool(torch.equal(mc, mg))}")
    report = {}
    for side, a, b in (("event", e_c, e_g), ("image", i_c, i_g)):
        pa = a["sparse_positions"][..., :2]
        pb = b["sparse_positions"][..., :2].cpu()
        same = (pa == pb).all(-1) & a["sparse_valid"]
        agree = float(same.sum() / a["sparse_valid"].sum().clamp(min=1))
        d_err = max_err(a["sparse_descriptors"][same],
                        b["sparse_descriptors"].cpu()[same])
        report[side] = (agree, d_err)
        print(f"[cpu-vs-gpu] {side} keypoints: {agree:.4f} of valid slots "
              f"at the same position, descriptor max|err| there "
              f"{d_err:.2e}")
    # over event slots at the same position on both devices and matched on
    # at least one: a match agrees when both devices match the slot to the
    # same image keypoint position
    same0 = (e_c["sparse_positions"][..., :2]
             == e_g["sparse_positions"][..., :2].cpu()).all(-1)

    def target(m0, image_feats):
        pos = image_feats["sparse_positions"][..., :2].cpu()
        idx = m0.cpu().long().clamp(min=0)[..., None].expand(-1, -1, 2)
        return m0.cpu() > -1, torch.gather(pos, 1, idx)

    hit_c, tgt_c = target(m_c["matches0"], i_c)
    hit_g, tgt_g = target(m_g["matches0"], i_g)
    agree = (hit_c == hit_g) & (~hit_c | (tgt_c == tgt_g).all(-1))
    scored = same0 & (hit_c | hit_g)
    match_agree = float(agree[scored].float().mean()) if scored.any() \
        else 1.0
    print(f"[cpu-vs-gpu] matches0 agree on {match_agree:.4f} of "
          f"{int(scored.sum())} matched slots")
    # thresholds: near-tied scores may swap a few slots (float32 sums in
    # another order on the card), so agreement is a rate, not exactness
    require(report["event"][0] >= 0.95 and report["image"][0] >= 0.95,
            f"keypoint agreement too low: {report}")
    require(report["event"][1] <= 1e-3 and report["image"][1] <= 1e-3,
            f"descriptor disagreement too high: {report}")
    require(match_agree >= 0.9, f"match agreement {match_agree:.3f} < 0.9")
    require(zero_flip <= 0.001 * rc.numel(), f"{zero_flip} voxel zero flips")
    return report, match_agree


def phase_cpu_vs_gpu_train():
    """One stage-2 step of a small float32 model (descriptors 256 in 4
    heads of 64, 2 layers, K=128) on the CPU (plain versions) and on the
    card (kernels D, F, C), same weights, batch and fill."""
    from ei_nexus_tpu_torch.data.synth import stage2_batch
    from ei_nexus_tpu_torch.flagship import (STAGE2_LR, stage2_config,
                                             stage2_train_state)
    from ei_nexus_tpu_torch.models.eim import EIM
    from ei_nexus_tpu_torch.models.layers import init_parameters
    from ei_nexus_tpu_torch.train.steps import make_stage2_train_step

    H, W, bins, K, B = 64, 96, 4, 128, 2
    cfg, _ = stage2_config(tiny=False, dtype="float32")
    kp = dataclasses.replace(cfg.event_extractor.keypoints,
                             detection_top_k=K, nms_impl="pallas")
    cfg = dataclasses.replace(
        cfg,
        event_extractor=dataclasses.replace(
            cfg.event_extractor, in_channels=bins, feat_channels=32,
            lat_channels=64, keypoints=kp),
        image_extractor=dataclasses.replace(cfg.image_extractor,
                                            keypoints=kp),
        matcher=dataclasses.replace(
            cfg.matcher, max_points_num=K,
            lightglue=dataclasses.replace(cfg.matcher.lightglue,
                                          n_layers=2)))
    cpu_model = EIM(cfg, training_heads=True)
    init_parameters(cpu_model, torch.Generator().manual_seed(2))
    gpu_model = copy.deepcopy(cpu_model).cuda()
    rng = np.random.default_rng(2)
    batch = stage2_batch(rng, B, 6000, 8192, H, W)
    # one fill for both devices: positions uniform over the image (zero
    # third column), unit normal descriptors
    pos = np.concatenate([rng.uniform(0, 1, (B, K, 2)) * [H, W],
                          np.zeros((B, K, 1))], -1).astype(np.float32)
    desc = rng.normal(size=(B, K, 256))
    desc = (desc / np.linalg.norm(desc, axis=-1, keepdims=True)).astype(
        np.float32)
    fill = tuple((torch.as_tensor(pos), torch.as_tensor(desc))
                 for _ in range(2))
    step = make_stage2_train_step("VoxelGrid", bins, H, W)
    res = {}
    for name, model in (("cpu", cpu_model), ("cuda", gpu_model)):
        state = stage2_train_state(model)
        dev_fill = tuple((p.to(name), d.to(name)) for p, d in fill)
        info = step(state, batch, fill=dev_fill)
        res[name] = ({k: float(v) for k, v in info.items()},
                     {k: v.cpu() for k, v in model.state_dict().items()})
    (ic, sc), (ig, sg) = res["cpu"], res["cuda"]
    e_loss = abs(ig["loss"] - ic["loss"]) / abs(ic["loss"])
    e_norm = abs(ig["grad_norm"] - ic["grad_norm"]) / ic["grad_norm"]
    e_par = max(max_err(sg[k], sc[k]) for k in sc)
    lr = STAGE2_LR
    print(f"[cpu-vs-gpu] stage-2 step: loss {ic['loss']:.6f} (cpu) vs "
          f"{ig['loss']:.6f} (card), rel {e_loss:.2e}; grad_norm "
          f"{ic['grad_norm']:.6f} vs {ig['grad_norm']:.6f}, rel "
          f"{e_norm:.2e}; updated parameters max|err| {e_par:.2e}; "
          f"gt_matches {ic['gt_matches']:.2f} vs {ig['gt_matches']:.2f}")
    # float32 sums in another order (and the kernels' online softmax);
    # Adam's first step moves a parameter by about lr whatever its
    # gradient's size, so a near-zero gradient of another sign flips it
    require(ic["gt_matches"] == ig["gt_matches"], "GT matches differ")
    require(e_loss <= 1e-4, f"stage-2 loss differs: rel {e_loss:.2e}")
    require(e_norm <= 1e-3, f"grad_norm differs: rel {e_norm:.2e}")
    require(e_par <= 4 * lr, f"updated parameters differ: {e_par:.2e}")
    return e_loss, e_norm, e_par


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from ei_nexus_tpu_torch.ops import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("[setup] TF32 off for matmuls and convolutions")
    t0 = time.perf_counter()
    logs = cuda_build.build()
    print(f"[setup] kernels built in {time.perf_counter() - t0:.1f} s "
          f"({', '.join(logs) or 'all cached'})")
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke_build.log"), "w") as f:
        for name, log in logs.items():
            f.write(f"== {name}\n{log}\n")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[setup] {name}: {line.strip()}")
    smi = nvidia_smi_line()
    print(f"[setup] {torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")

    rows = phase_kernels()
    launches, fwd_ms, B = phase_main_path()
    train_launches, step_ms = phase_stage2()
    for r in rows:
        r["launches"] = (train_launches if r["name"].startswith(
            "attention_") else launches)[r["name"]]
    phase_cpu_vs_gpu()
    phase_cpu_vs_gpu_train()

    print(json.dumps({"kernels": rows}))
    print(f"flagship forward: {B / fwd_ms * 1e3:.2f} pairs/s "
          f"({fwd_ms:.3f} ms per batch of {B}, back to back) on {smi}")
    print(f"stage-2 training step: {1e3 / step_ms:.3f} steps/s "
          f"({step_ms:.3f} ms per step of {B} pairs, back to back) on {smi}")
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
