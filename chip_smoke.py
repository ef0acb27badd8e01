#!/usr/bin/env python
"""Smoke run of the PyTorch/CUDA port (`ei_nexus_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure:
 1. setup: a CUDA device is required; the kernels are built from
    `ei_nexus_tpu_torch/csrc` (one nvcc per source, all at once); TF32 is
    switched off for matmuls and convolutions so float32 comparisons are
    float32; the card's name and power limit are printed;
 2. the build of the Hopper loops of A, B, D, E, F and G
    (csrc/flash_sm90.cuh, csrc/attention_bwd.cu): their kernels' ptxas
    lines (no spill, no C7508 "setmaxnreg ignored"), shared memory, and
    HGMMA and UTMALDG instructions in the SASS of each library where the
    toolkit has cuobjdump; then every kernel (A-G) against its plain
    PyTorch version at the paths' shapes, in float32 and bfloat16 (E at
    block_q 64 and 128, with and without rot; G at 1024 and 2048 tokens
    with random query and key segments and a fully masked batch row; D and
    F with a fully masked batch row, held alone too, F reading the v D
    packed), timed with CUDA events beside the plain
    version, the library call that computes the same function (SDPA for
    the attention kernels: forward for A, B, D, E, G, with the same bool
    mask; SDPA's backward, (forward + backward) - forward, for F) and the
    card's bound; each kernel and its library call also by device time
    alone (torch.profiler: the CUDA-event time of calls back to back is
    paced by the host where a call costs it more than the card), A, D, E
    and G with the pack pass's own share (D also on the cross layout, read
    in place), F split into its c pass, pack pass and its two block kinds
    (each run alone); F's gradients are also held to a
    relative norm, which planted faults (c = 0, c or the row statistics of
    the neighbouring row) must break; kernel C (fixed-round NMS, one
    launch of independent thread-block clusters of 8 blocks, each map or
    tile of a map held in one cluster's distributed shared memory for all
    rounds): its ptxas line at radius 4 and, for all 16 instances, the
    library's resource usage (no stack frame, no local memory), its plan
    at the flagship's (8, 264, 352) (rows a block, tiles) and the clusters
    that fit at once, bit-exact there in float32 and bfloat16 and at
    (1, 1080, 3840), which the plan cuts into row and column strips with
    ghost rows and columns, and its device time at both;
 3. the flagship EIM forward at full width (260x346, 16 bins, K=1024,
    9 LightGlue layers of 4x64, bfloat16, B=8) on bursty events, once for
    each attention setting of `build_flagship`: "auto" (A=18, B=9, C=2
    launches a forward), "flash" (G=36, C=2) and "auto" with block_q=64
    (E=36, C=2), launch counts read around one forward (and the Hopper
    loops' pack passes: 18 under "auto", 18 q-blocked, 18 "flash"), then
    timed one forward at a time (latency) and back to back (throughput,
    pairs/s);
    the flash forward is then chained with the pose tail as the JAX
    package's bench.py chains them (pairs/s with pose, the pose tail's ms
    per batch, its host syncs);
 4. the stage-2 training step at full width (the same model with both
    extractors frozen and LightGlue trained, AdamW, B=8): launch counts
    read around one step (D and F 36 each, C 2, A, B, E, G none; 18 pack
    passes, D's self-attention v, which F reads in place), finite
    loss, grad_norm > 0, frozen parameters and BatchNorm statistics
    bit-unchanged, matcher parameters changed, the loss lower after 10
    steps on the same batch and fill, then steps/s over 24 steps back to
    back with the spread of single steps, and peak memory;
 5. one small float32 model on the CPU (plain versions) and on the card
    (kernels), same weights and inputs: the inference forward and one
    stage-2 step (same batch and fill), agreement bounded;
 6. the pose tail (5-point RANSAC and pose recovery) on eight synthetic
    scenes, on the CPU and on the card with the same injected samples:
    float64 agreement to 1e-4, and the rotation within 1 degree of the
    truth in float64 and float32 on both devices;
 7. the "auto" forward fed by the data path: a DataLoader of 4 threads
    over `LoaderPairs` (the readers' sample contract, 27k-55k events a
    window in 262,144 slots), the C++ wire encode (required), the pinned
    put and `serve.serve_loader`: the decode on the card bit-equal to the
    host's round(v*64)/64, wire-fed matches equal to float-fed ones,
    launches a batch A 18, B 9, C 2 over the timed pass; pairs/s,
    host-only pairs/s, host share, buckets taken, and the encode and put
    of one batch alone;
 8. the stage-1 model (the flagship with the MNN matcher) at inference,
    B=8: C 2 launches a forward and no attention kernel, latency and
    pairs/s; its tiny float32 config on the CPU and the card: matches
    equal;
 9. stage-1 training (the event extractor distilled against the frozen
    SuperPoint): (a) the flagship stage-1 step at full width
    (`build_stage1_flagship`, bf16, B=8, the bursty events): launches
    read around one step, none (the step runs no NMS, top-k or attention,
    as the compiled JAX step does not), finite loss and terms, grad_norm
    > 0, SuperPoint bit-unchanged, every event-extractor parameter and
    running statistic changed, the loss lower after 10 more steps on the
    batch, steps/s over 24 steps back to back with the spread of single
    steps and peak memory, beside phase 4's stage-2 steps/s; (b) one step
    of the tiny float32 config on the CPU and the card: loss, grad_norm,
    updated parameters and running statistics agree within stated
    bounds; (c) the entry point from disk: a mini-EC of the six EC
    training sequences rendered from a seed into a temporary directory,
    `python -m ei_nexus_tpu_torch.train_extractor --config
    configs/train_EIM_stage1_EC_SP_MNN.yaml --max-steps 4` on the card
    (160x160 crops, B=8, 4 loader threads): exit 0, finite logged losses,
    a `final` checkpoint; then `--resume` from it to step 6, and the
    entry's steady steps/s;
10. the SiLK family (the cell-1 event extractor `vgg_np` and the frozen
    SiLK, `flagship.silk_config`): (a) the EI_SiLK_LG forward at full
    width (bf16, B=8, 260x346, K=1024, LightGlue through its 128 -> 256
    input projection): launches A 18, B 9, C 2 and 18 pack passes, its
    latency, pairs/s beside phase 3's "auto" forward and peak memory; (b)
    EI_SiLK_MNN and SiLKMatcher: C 2 each, pairs/s; (c) kernel C at the
    cell-1 score maps (8, 260, 346) and (8, 242, 328) (padding 1 and 0):
    its plan, bit-exact in float32 and bfloat16, its device time; (d)
    tiny float32 EI_SiLK_LG and EI_SiLK_MNN, and EI_SiLK_LG with both
    extractors at padding 0, on the CPU and the card: keypoints, validity
    and matches equal, maps within 1e-3; (e) the EIM_stage2_SiLK_LG step
    at full width through phase 4's runner (D 36, F 36, C 2); (f) the
    SiLK stage-1 entry, `--config configs/train_EIM_stage1_EC_SiLK_MNN
    .yaml --max-steps 4` over phase 9's rendered mini-EC: exit 0, finite
    losses, a `final` checkpoint, its steady steps/s; (g) every event
    representation at B=8, 131,072 slots, 16 bins, 260x346 on the card
    against the CPU (the DistanceMap's CPU side on one stream): bit-equal
    but for the voxel grid (held as phase 5 holds it), the card's ms.

Prints each phase's wall seconds, the kernels' JSON line (launches: A, B,
C from the "auto" forward; D, F from the stage-2 step; E from the
q-blocked forward; G from the flash forward; each row's
launches_stage1_step from the stage-1 step, launches_silk_lg_forward and
launches_silk_stage2_step from phase 10; C's row also its device ms and
plans at the cell-1 shapes), the card's `nvidia-smi` line, the forward,
serving, loader-fed, MNN, SiLK, step and entry rates, and as its last
line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits non-zero without a card. Writes the nvcc/ptxas log to
chiprun_out/chip_smoke_build.log.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
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
NMS_STRIP_SHAPE = (1, 1080, 3840)   # a 4K frame: tiles of rows and columns
QBLOCKS = (64, 128)          # kernel E's compiled tiles
FLASH_TOKENS = (1024, 2048)  # kernel G: the flagship, and what "flash" is for


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


def device_ms(fn, iters: int = 20) -> dict:
    """{kernel name: device ms per call} of the kernels one call of `fn`
    launches, traced by torch.profiler over `iters` calls after a warm-up
    (what the card spends, without the host's pace)."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = e.device_time if hasattr(e, "device_time") else e.cuda_time
            out[e.name] = out.get(e.name, 0.0) + us / 1e3 / iters
    return out


def _sum_ms(times: dict, fragment: str = "") -> float:
    return sum(ms for name, ms in times.items() if fragment in name)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

# the Hopper loops of A, B, D, E, F and G (csrc/flash_sm90.cuh; F's in
# csrc/attention_bwd.cu) and their pack pass
HOPPER_LIBS = ("self_attention", "qblock_attention", "cross_attention",
               "attention_fwd", "attention_bwd", "flash_segment")
HOPPER_KERNELS = ("sm90_kernel", "attention_pack_kernel")


def check_hopper_build(logs: dict) -> dict:
    """Print ptxas's lines for the Hopper kernels (registers, spills, stack;
    their dynamic shared memory from the library; any C75xx remark such as
    C7508, setmaxnreg ignored) and require no spill and no C7508; where
    the toolkit has cuobjdump, count HGMMA (wgmma) and UTMALDG (TMA load)
    instructions in each library's SASS and require both. Returns
    {library: {"HGMMA": n, "UTMALDG": n}}."""
    from ei_nexus_tpu_torch.ops import cuda_build
    for name in HOPPER_LIBS:
        log = logs.get(name)
        if log is None:
            print(f"[kernels] {name}: built before this run, no ptxas log")
            continue
        fn = None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                fn = m.group(1)
                continue
            if "C75" in line and any(k in line for k in HOPPER_KERNELS):
                print(f"[kernels] {name}: {line.strip()}")
                require("C7508" not in line, f"setmaxnreg ignored: {line}")
            if fn and any(k in fn for k in HOPPER_KERNELS) and (
                    "spill" in line or "registers" in line):
                print(f"[kernels] {name} {fn}: {line.strip()}")
                m = re.search(r"(\d+) bytes spill stores", line)
                require(m is None or int(m.group(1)) == 0,
                        f"{fn} spills: {line.strip()}")
        lib = cuda_build.library(name)
        if name == "attention_bwd":
            print(f"[kernels] {name}: loop's dynamic shared memory "
                  f"{lib.ei_bwd_sm90_smem_bytes()} bytes a block (64 keys "
                  f"or 64 queries)")
        else:
            print(f"[kernels] {name}: loop's dynamic shared memory "
                  f"{lib.ei_sm90_smem_bytes(1)} bytes a block (64 rows), "
                  f"{lib.ei_sm90_smem_bytes(2)} (128 rows)")
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    counts = {}
    if not os.path.isfile(tool):
        print("[kernels] no cuobjdump in the toolkit: SASS not counted")
        return counts
    for name in HOPPER_LIBS:
        sass = subprocess.run(
            [tool, "-sass", str(cuda_build.library_path(name))],
            capture_output=True, text=True, check=True, timeout=300).stdout
        counts[name] = {op: sass.count(op) for op in ("HGMMA", "UTMALDG")}
        print(f"[kernels] {name} SASS: {counts[name]}")
        require(all(counts[name].values()),
                f"{name}: no wgmma or no TMA load in the SASS")
    return counts



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
    the float32 row statistics (max and sum). F: the five products of the
    TPU backward (10BhNMd); reads q, k, v, the output, dO, the bias and the
    row statistics, writes dq, dk, dv."""
    B, h, N, d = q.shape
    M = k.shape[2]
    es = q.element_size()
    if kind == "fwd":
        flops = 4.0 * B * h * N * M * d
        nbytes = (2 * N + 2 * M) * B * h * d * es + B * M * 4 + B * h * N * 8
    else:
        flops = 10.0 * B * h * N * M * d
        nbytes = ((4 * N + 4 * M) * B * h * d * es + B * M * 4
                  + B * h * N * 8)
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
    """Kernels D and F against their plain versions on both cases, with the
    last batch row's keys all masked (held alone too: a uniform softmax), F
    reading the v D read (its packed copy where D packed it, as
    `fused_attention` hands it on), and planted faults of F (c = 0, c or
    the row statistics of the neighbouring row) that F's relative-norm
    check must catch; returns the largest errors (D, F), each case's
    tensors for timing and F's largest relative norm."""
    from ei_nexus_tpu_torch.ops import attention_kernels as ak
    err_d = err_f = rel_f = 0.0
    caught = float("inf")
    kept = {}
    for case, (q, k, v, mask, scale) in fused_cases(x).items():
        B, h, N, d = q.shape
        mask = mask.clone()
        mask[-1] = False
        bias = ak.key_bias(mask, B, k.shape[2], "cuda")
        out, stats, v_read = ak.attention_fwd(q, k, v, bias, scale)
        want = ak.fused_attention_plain(q, k, v, mask, scale)
        torch.cuda.synchronize()
        e = max_err(out, want)
        require(e <= tol * max(1.0, float(want.float().abs().max())),
                f"attention_fwd ({case}) disagrees in {dtype}: {e:.3e}")
        err_d = max(err_d, e)
        # dO as autograd hands it: a (B, h, N, d) view of (B, N, h, d)
        do = torch.randn(B, N, h, d, generator=gen, device="cuda").to(
            dtype).permute(0, 2, 1, 3)
        got = ak.attention_bwd(q, k, v_read, out, do, bias, stats, scale)
        want = ak.fused_attention_bwd_plain(q, k, v, bias, do, scale)
        torch.cuda.synchronize()
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            # all rows, then the fully masked batch row alone
            for rows, which in ((slice(None), ""), (-1, ", masked row")):
                e, r = max_err(a[rows], b[rows]), rel_err(a[rows], b[rows])
                bound = tol * max(1.0, float(b[rows].float().abs().max()))
                require(e <= bound, f"attention_bwd {name} ({case}{which}) "
                                    f"disagrees in {dtype}: {e:.3e} > "
                                    f"{bound:.3e}")
                require(r <= BWD_REL[dtype],
                        f"attention_bwd {name} ({case}{which}) disagrees in "
                        f"{dtype}: relative norm {r:.3e} > "
                        f"{BWD_REL[dtype]:g}")
                err_f, rel_f = max(err_f, e), max(rel_f, r)
        # F reads c = rowsum(dO o O) from the output: a zero output plants
        # c = 0, a rolled one the neighbouring row's c
        for o, st in ((torch.zeros_like(out), stats), (out.roll(1, 2), stats),
                      (out, stats.roll(1, -1))):
            bad = ak.attention_bwd(q, k, v_read, o, do, bias, st, scale)
            caught = min(caught, max(rel_err(a, b)
                                     for a, b in zip(bad, want)))
        kept[case] = (q, k, v, mask, scale, bias, out, stats, do, v_read)
    torch.cuda.synchronize()
    require(caught > 5 * BWD_REL[dtype],
            f"a planted fault of attention_bwd moves the relative norm only "
            f"{caught:.3e} in {dtype}")
    print(f"[kernels] {dtype}: attention_fwd max|err| {err_d:.3e}, "
          f"attention_bwd max|err| {err_f:.3e} (tol {tol:g} x max(1, "
          f"max|ref|)), relative norm {rel_f:.3e} (tol {BWD_REL[dtype]:g}; "
          f"planted faults: {caught:.3e} or more), self and cross, key-side "
          f"masks, the last batch row fully masked (held alone too)")
    return err_d, err_f, kept, rel_f


def check_qblock(x, dtype, tol):
    """Kernel E against its plain version at both compiled tiles, rotary
    fused (the self-attention case, scale d^-0.5) and rotary-free (one
    cross direction, pre-scaled, scale 1); returns the largest error and
    the bf16 cases for timing."""
    from ei_nexus_tpu_torch.ops import attention_kernels as ak
    b0 = ak.key_bias(x["mask0"], MAIN_B, MAIN_N, "cuda")
    b1 = ak.key_bias(x["mask1"], MAIN_B, MAIN_N, "cuda")
    cases = {"rot": (x["q"], x["k"], x["v"], b0, MAIN_D ** -0.5, x["rot"]),
             "rot-free": (x["qk0"], x["qk1"], x["v1"], b1, 1.0, None)}
    worst = 0.0
    for block_q in QBLOCKS:
        for case, (q, k, v, bias, scale, rot) in cases.items():
            got = ak.qblock_attention(q, k, v, bias, scale, block_q, rot)
            want = ak.qblock_attention_plain(q, k, v, bias, scale, rot)
            torch.cuda.synchronize()
            e = max_err(got, want)
            bound = tol * max(1.0, float(want.float().abs().max()))
            require(e <= bound, f"qblock_attention ({case}, block_q "
                                f"{block_q}) disagrees in {dtype}: {e:.3e}")
            worst = max(worst, e)
    print(f"[kernels] {dtype}: qblock_attention max|err| {worst:.3e} (tol "
          f"{tol:g} x max(1, max|ref|)), block_q {QBLOCKS}, with and "
          f"without rot")
    return worst, cases


def flash_inputs(n, dtype, gen):
    """Kernel G's operands at n tokens as LightGlue's "flash" self-attention
    gives them (q, k after the rotary, v the stride-3 view of the Wqkv
    output), with segment ids that are not all 1: queries in segments 1
    and 2, keys 1 where valid and 2 where not, and the last batch row's
    keys all in segment 3, which no query has (a fully masked row)."""
    from ei_nexus_tpu_torch.ops.attention_kernels import rotate_half
    B, h, d = MAIN_B, MAIN_H, MAIN_D
    qkv = torch.randn(B, n, h * d * 3, generator=gen, device="cuda").to(
        dtype).unflatten(-1, (h, d, 3)).transpose(1, 2)
    ang = torch.rand(B, n, d // 2, generator=gen, device="cuda") * 2 * np.pi
    cos, sin = (torch.repeat_interleave(f(ang), 2, -1).to(dtype)[:, None]
                for f in (torch.cos, torch.sin))
    q, k = (t * cos + rotate_half(t) * sin for t in (qkv[..., 0],
                                                      qkv[..., 1]))
    q_seg = torch.randint(1, 3, (B, n), generator=gen, device="cuda",
                          dtype=torch.int32)
    mask = torch.rand(B, n, generator=gen, device="cuda") > 0.2
    kv_seg = torch.where(mask, 1, 2).to(torch.int32)
    kv_seg[-1] = 3
    return q, k, qkv[..., 2], q_seg, kv_seg


def check_flash(dtype, tol, gen):
    """Kernel G against its plain version at the flagship's 1024 tokens
    and at 2048 (the token count the JAX package keeps it for); returns
    the largest error and the bf16 operands by token count."""
    from ei_nexus_tpu_torch.ops import flash_kernel as fk
    worst, kept = 0.0, {}
    for n in FLASH_TOKENS:
        x = flash_inputs(n, dtype, gen)
        got = fk.flash_attention(*x, MAIN_D ** -0.5)
        want = fk.flash_attention_plain(*x, MAIN_D ** -0.5)
        torch.cuda.synchronize()
        e = max_err(got, want)
        bound = tol * max(1.0, float(want.float().abs().max()))
        require(bool(torch.isfinite(got.float()).all()),
                f"flash_attention gives non-finite values in {dtype}")
        require(e <= bound, f"flash_attention ({n} tokens) disagrees in "
                            f"{dtype}: {e:.3e}")
        worst = max(worst, e)
        kept[n] = x
    print(f"[kernels] {dtype}: flash_attention max|err| {worst:.3e} (tol "
          f"{tol:g} x max(1, max|ref|)), {FLASH_TOKENS} tokens, random "
          f"query and key segments, one fully masked batch row")
    return worst, kept


def flash_bound_ms(q: torch.Tensor, k: torch.Tensor) -> tuple:
    """Bound of one bf16 call of kernel G: QK^T and PV (4BhNMd); reads q,
    k, v and the int32 segment ids, writes the output."""
    B, h, N, d = q.shape
    M = k.shape[2]
    nbytes = (2 * N + 2 * M) * B * h * d * q.element_size() + 4 * B * (N + M)
    return _bound(4.0 * B * h * N * M * d, PEAK_BF16_FLOPS, nbytes)


def sdpa_segment_ms(x) -> tuple:
    """SDPA on the same operands with the same mask as a (B, 1, N, M) bool
    tensor, the yardstick of kernel G: (CUDA-event ms, device ms)."""
    q, k, v, q_seg, kv_seg = x
    am = q_seg[:, None, :, None] == kv_seg[:, None, None, :]
    qc, kc, vc = (t.contiguous() for t in (q, k, v))

    def call():
        return F.scaled_dot_product_attention(qc, kc, vc, attn_mask=am,
                                              scale=MAIN_D ** -0.5)
    return cuda_ms(call), _sum_ms(device_ms(call))


def check_nms_build(logs: dict) -> None:
    """Kernel C's build: ptxas's lines for its instances at the flagship's
    radius where this run built the library (registers, stack frame,
    spills), and for every instance the library's resource usage from
    cuobjdump: no stack frame and no local memory. A window array that
    falls out of registers shows as a stack frame, not as a spill."""
    from ei_nexus_tpu_torch.ops import cuda_build
    log = logs.get("nms")
    if log is None:
        print("[kernels] nms: built before this run, no ptxas log")
    else:
        fn = None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                fn = m.group(1)
                continue
            if fn and "nms_kernel" in fn and ("spill" in line
                                              or "registers" in line):
                if f"Li{NMS_RADIUS}E" in fn:
                    print(f"[kernels] nms {fn}: {line.strip()}")
                for what in ("stack frame", "spill stores"):
                    m = re.search(rf"(\d+) bytes {what}", line)
                    require(m is None or int(m.group(1)) == 0,
                            f"{fn}: {line.strip()}")
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.isfile(tool):
        require(log is not None, "kernel C: no ptxas log and no cuobjdump "
                                 "to read its stack frame")
        print("[kernels] nms: no cuobjdump in the toolkit, resource usage "
              "not read")
        return
    usage = subprocess.run(
        [tool, "-res-usage", str(cuda_build.library_path("nms"))],
        capture_output=True, text=True, check=True, timeout=120).stdout
    found = re.findall(r"Function (\S*nms_kernel\S*?):\s*\n\s*(REG:.*)",
                       usage)
    require(len(found) == 16, f"kernel C: {len(found)} instances in the "
                              f"library's resource usage, 16 expected")
    for fn, line in found:
        if f"Li{NMS_RADIUS}E" in fn:
            print(f"[kernels] nms {fn} resource usage: {line.strip()}")
        for what in ("STACK", "LOCAL"):
            m = re.search(rf"\b{what}:(\d+)", line)
            require(m is not None and int(m.group(1)) == 0,
                    f"{fn}: {line.strip()}")


def check_nms(gen) -> dict:
    """Kernel C at the flagship's (8, 264, 352): its plan and the clusters
    that fit at once, bit-exact in float32 and bfloat16 and at a map cut
    into tiles of rows and columns, timed at both. Returns its row of the
    kernels' JSON line (without launches)."""
    from ei_nexus_tpu_torch.ops import cuda_build
    from ei_nexus_tpu_torch.ops import nms_kernel as nk
    score = torch.rand(*NMS_SHAPE, generator=gen, device="cuda")
    score = torch.where(score > 0.3, score, torch.zeros_like(score))
    plan = nk.nms_plan(*NMS_SHAPE, NMS_RADIUS, NMS_ROUNDS,
                       score.element_size())
    active = cuda_build.library("nms").ei_nms_active_clusters(0, NMS_RADIUS)
    print(f"[kernels] nms_rounds plan at {NMS_SHAPE} float32: clusters of "
          f"{plan.cluster} blocks, {plan.rows} rows of {plan.width} a block, "
          f"row strips {plan.row_strips}, column strips {plan.col_strips} "
          f"(own0, own1, load0, load1), {plan.smem_bytes} bytes of shared "
          f"memory a block; clusters that fit at once: {active}")
    require(active > 0, f"no cluster of kernel C fits the card ({active})")
    require(len(plan.row_strips) == len(plan.col_strips) == 1,
            "the flagship's map is not one cluster")
    for dtype in (torch.float32, torch.bfloat16):
        x = score.to(dtype)
        got = nk.nms_rounds(x, NMS_RADIUS, NMS_ROUNDS)
        want = nk.nms_rounds_plain(x, NMS_RADIUS, NMS_ROUNDS)
        torch.cuda.synchronize()
        require(torch.equal(got, want),
                f"NMS kernel is not bit-exact in {dtype}: "
                f"{int((got != want).sum())} pixels differ")
    # a map one cluster cannot hold: tiles with ghost rows and columns
    big = torch.rand(*NMS_STRIP_SHAPE, generator=gen, device="cuda")
    big = torch.where(big > 0.3, big, torch.zeros_like(big))
    big_plan = nk.nms_plan(*NMS_STRIP_SHAPE, NMS_RADIUS, NMS_ROUNDS, 4)
    require(len(big_plan.row_strips) > 1 and len(big_plan.col_strips) > 1,
            f"{NMS_STRIP_SHAPE} is not cut into rows and columns")
    require(torch.equal(nk.nms_rounds(big, NMS_RADIUS, NMS_ROUNDS),
                        nk.nms_rounds_plain(big, NMS_RADIUS, NMS_ROUNDS)),
            f"NMS kernel is not bit-exact at {NMS_STRIP_SHAPE}")
    print(f"[kernels] nms_rounds: bit-exact in float32 and bfloat16 at "
          f"{NMS_SHAPE}, and at {NMS_STRIP_SHAPE} in "
          f"{len(big_plan.row_strips)} x {len(big_plan.col_strips)} tiles "
          f"of {big_plan.ghost} ghost rows and columns")
    t_c = cuda_ms(lambda: nk.nms_rounds(score, NMS_RADIUS, NMS_ROUNDS))
    t_c_plain = cuda_ms(lambda: nk.nms_rounds_plain(score, NMS_RADIUS,
                                                    NMS_ROUNDS))
    dev_c = _sum_ms(device_ms(lambda: nk.nms_rounds(score, NMS_RADIUS,
                                                    NMS_ROUNDS)))
    dev_c_big = _sum_ms(device_ms(lambda: nk.nms_rounds(
        big, NMS_RADIUS, NMS_ROUNDS)))
    print(f"[kernels] nms_rounds device ms a call: {dev_c:.4f}; "
          f"{NMS_STRIP_SHAPE}: {dev_c_big:.4f}")
    b_c, by_c = nms_bound_ms(score)
    return dict(name="nms_rounds", route="cuda",
                source="ei_nexus_tpu_torch/csrc/nms.cu",
                replaces="ei_nexus_tpu/ops/pallas_nms.py:57",
                max_abs_err=0.0, max_abs_err_f32=0.0,
                ms=t_c, plain_ms=t_c_plain, bound_ms=b_c, bound_by=by_c,
                library_ms=None,
                design=f"one launch of independent clusters of "
                       f"{plan.cluster} blocks, each map held in a "
                       f"cluster's distributed shared memory for all "
                       f"rounds ({plan.rows} rows a block), halo rows read "
                       f"from the peers, two cluster barriers a round; "
                       f"is_max dilated as bits",
                device_ms=dev_c, library_device_ms=None,
                device_ms_strips=dev_c_big,
                strips_shape=list(NMS_STRIP_SHAPE))


def phase_kernels(logs: dict):
    from ei_nexus_tpu_torch.ops import attention_kernels as ak

    sass = check_hopper_build(logs)
    check_nms_build(logs)
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = {}
    fused_errs, qblock_errs, flash_errs = {}, {}, {}
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
        qblock_errs[dtype] = check_qblock(x, dtype, tol)
        flash_errs[dtype] = check_flash(dtype, tol, gen)
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
    # device time alone (the calls above are paced by the host when its
    # share of a call is the larger): A's loop and pack pass, SDPA's kernels
    dev_a = device_ms(lambda: ak.self_attention(
        x["q"], x["k"], x["v"], x["mask0"], rot=x["rot"]))
    dev_a_lib = device_ms(lambda: F.scaled_dot_product_attention(
        qr, kr, vc, attn_mask=am0))
    print(f"[kernels] self_attention_rot device ms a call: loop "
          f"{_sum_ms(dev_a, 'sm90_kernel'):.4f}, pack "
          f"{_sum_ms(dev_a, 'attention_pack'):.4f}, all "
          f"{_sum_ms(dev_a):.4f}; SDPA {_sum_ms(dev_a_lib):.4f} "
          + json.dumps({n[:48]: round(v, 4) for n, v in dev_a_lib.items()}))
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
    dev_b_all = device_ms(lambda: ak.cross_attention_bidir(
        x["qk0"], x["qk1"], x["v0"], x["v1"], x["mask0"], x["mask1"]))
    dev_b, dev_b_lib = _sum_ms(dev_b_all), _sum_ms(device_ms(sdpa_bidir))
    print(f"[kernels] cross_attention_bidir device ms a call: loop "
          f"{_sum_ms(dev_b_all, 'sm90_kernel'):.4f}, all {dev_b:.4f}; SDPA "
          f"(two calls) {dev_b_lib:.4f}")

    # D and F on the bf16 self-attention case (its last batch row fully
    # masked; SDPA's yardsticks take the unmasked rows of x["mask0"], as a
    # fully masked bool row is NaN there); F reads the v D packed, as in
    # the training step. D also on the cross layout (read in place)
    q, k, v, mask, scale, bias, out, stats, do, v_read = \
        fused_errs[torch.bfloat16][2]["self"]
    t_d = cuda_ms(lambda: ak.attention_fwd(q, k, v, bias, scale))
    t_d_plain = cuda_ms(lambda: ak.fused_attention_plain(q, k, v, mask,
                                                         scale), iters=5)
    t_f = cuda_ms(lambda: ak.attention_bwd(q, k, v_read, out, do, bias,
                                           stats, scale))
    t_f_plain = cuda_ms(lambda: ak.fused_attention_bwd_plain(
        q, k, v, bias, do, scale), iters=5)
    qg, kg, vg = (t.detach().contiguous().requires_grad_() for t in (q, k, v))
    dog = do.contiguous()
    am = x["mask0"][:, None, None, :]
    with torch.no_grad():
        t_d_lib = cuda_ms(lambda: F.scaled_dot_product_attention(
            qg, kg, vg, attn_mask=am, scale=scale))

    def sdpa_fwd():
        return F.scaled_dot_product_attention(qg, kg, vg, attn_mask=am,
                                              scale=scale)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa_fwd(), (qg, kg, vg), dog)
    t_f_lib = cuda_ms(sdpa_fwd_bwd) - cuda_ms(sdpa_fwd)
    dev_d_all = device_ms(lambda: ak.attention_fwd(q, k, v, bias, scale))
    dev_d = _sum_ms(dev_d_all)
    xq, xk, xv, _, xscale, xbias = fused_errs[torch.bfloat16][2]["cross"][:6]
    t_d_cross = cuda_ms(lambda: ak.attention_fwd(xq, xk, xv, xbias, xscale))
    dev_d_cross = _sum_ms(device_ms(
        lambda: ak.attention_fwd(xq, xk, xv, xbias, xscale)))
    print(f"[kernels] attention_fwd device ms a call: self loop "
          f"{_sum_ms(dev_d_all, 'sm90_kernel'):.4f}, pack "
          f"{_sum_ms(dev_d_all, 'attention_pack'):.4f}, all {dev_d:.4f}; "
          f"cross (in place) {dev_d_cross:.4f}")
    dev_f_all = device_ms(lambda: ak.attention_bwd(q, k, v_read, out, do,
                                                   bias, stats, scale))
    dev_f = _sum_ms(dev_f_all)
    # F's split: the c pass and the pack pass from the whole call; each
    # block kind from a call that runs it alone
    f_split = {"c pass": _sum_ms(dev_f_all, "row_dot_kernel"),
               "pack": _sum_ms(dev_f_all, "attention_pack_kernel"),
               "loop": _sum_ms(dev_f_all, "sm90_kernel")}
    for blocks, kind in ((1, "dK/dV blocks alone"), (2, "dQ blocks alone")):
        f_split[kind] = _sum_ms(device_ms(lambda: ak.attention_bwd(
            q, k, v_read, out, do, bias, stats, scale, blocks=blocks)),
            "sm90_kernel")
    with torch.no_grad():
        dev_d_lib = _sum_ms(device_ms(sdpa_fwd))
    dev_f_lib = _sum_ms(device_ms(sdpa_fwd_bwd)) - _sum_ms(device_ms(sdpa_fwd))
    print(f"[kernels] attention_bwd device ms a call: all {dev_f:.4f}; "
          + ", ".join(f"{k} {v:.4f}" for k, v in f_split.items())
          + f"; SDPA's backward {dev_f_lib:.4f}")

    row_c = check_nms(gen)

    # E as the q-blocked forward runs it (block_q 64; rot in the self
    # layers, rot-free in the cross directions), and at block_q 128
    cases = qblock_errs[torch.bfloat16][1]
    t_e = {}
    for block_q in QBLOCKS:
        for case, (q, k, v, bias, scale, rot) in cases.items():
            t_e[case, block_q] = cuda_ms(
                lambda: ak.qblock_attention(q, k, v, bias, scale, block_q,
                                            rot))
    dev_e = {}
    for block_q in QBLOCKS:
        for case, (q, k, v, bias, scale, rot) in cases.items():
            dev_e[case, block_q] = device_ms(
                lambda: ak.qblock_attention(q, k, v, bias, scale, block_q,
                                            rot))
            print(f"[kernels] qblock_attention ({case}, block_q {block_q}): "
                  f"{t_e[case, block_q]:.4f} ms a call (CUDA events), "
                  f"device: loop "
                  f"{_sum_ms(dev_e[case, block_q], 'sm90_kernel'):.4f}, "
                  f"pack {_sum_ms(dev_e[case, block_q], 'pack_kernel'):.4f}")
    q, k, v, bias, scale, rot = cases["rot"]
    t_e_plain = cuda_ms(lambda: ak.qblock_attention_plain(
        q, k, v, bias, scale, rot), iters=5)
    b_e, by_e = attention_bound_ms("self", q, k)

    # G at the flagship's tokens and at 2048
    from ei_nexus_tpu_torch.ops import flash_kernel as fk
    t_g, t_g_plain, t_g_lib, b_g, dev_g, dev_g_lib = {}, {}, {}, {}, {}, {}
    g_split = {}
    n0, n1 = FLASH_TOKENS
    for n, xg in flash_errs[torch.bfloat16][1].items():
        t_g[n] = cuda_ms(lambda: fk.flash_attention(*xg, MAIN_D ** -0.5))
        t_g_plain[n] = cuda_ms(lambda: fk.flash_attention_plain(
            *xg, MAIN_D ** -0.5), iters=5)
        t_g_lib[n], dev_g_lib[n] = sdpa_segment_ms(xg)
        dev_g_all = device_ms(lambda: fk.flash_attention(*xg,
                                                         MAIN_D ** -0.5))
        dev_g[n] = _sum_ms(dev_g_all)
        g_split[n] = (_sum_ms(dev_g_all, "sm90_kernel"),
                      _sum_ms(dev_g_all, "attention_pack"))
        b_g[n] = flash_bound_ms(xg[0], xg[1])
        print(f"[kernels] flash_attention ({n} tokens) device ms a call: "
              f"loop {g_split[n][0]:.4f}, pack {g_split[n][1]:.4f}, all "
              f"{dev_g[n]:.4f}; SDPA {dev_g_lib[n]:.4f}")

    b_a, by_a = attention_bound_ms("self", x["q"], x["k"])
    b_b, by_b = attention_bound_ms("cross", x["qk0"], x["qk1"])
    b_d, by_d = fused_bound_ms("fwd", q, k)
    b_f, by_f = fused_bound_ms("bwd", q, k)
    rows = [
        dict(name="self_attention_rot", route="cuda",
             source="ei_nexus_tpu_torch/csrc/self_attention.cu",
             replaces="ei_nexus_tpu/ops/pallas_attention.py:289",
             max_abs_err=errs[torch.bfloat16][0],
             max_abs_err_f32=errs[torch.float32][0],
             ms=t_a, plain_ms=t_a_plain, bound_ms=b_a, bound_by=by_a,
             library_ms=t_a_lib,
             design="bf16: pack pass (rotary, de-interleave, once a token) "
                    "then a TMA + wgmma warp-specialised flash loop, 128 "
                    "rows a block in two consumer warpgroups; f32: "
                    "CUDA-core flash loop",
             pack_ms=_sum_ms(dev_a, "attention_pack"),
             device_ms=_sum_ms(dev_a), library_device_ms=_sum_ms(dev_a_lib),
             sass=sass.get("self_attention")),
        dict(name="cross_attention_bidir", route="cuda",
             source="ei_nexus_tpu_torch/csrc/cross_attention.cu",
             replaces="ei_nexus_tpu/ops/pallas_attention.py:187",
             max_abs_err=errs[torch.bfloat16][1],
             max_abs_err_f32=errs[torch.float32][1],
             ms=t_b, plain_ms=t_b_plain, bound_ms=b_b, bound_by=by_b,
             library_ms=t_b_lib,
             design="bf16: one launch of the TMA + wgmma warp-specialised "
                    "flash loop for both directions, 64 rows a block in one "
                    "consumer warpgroup, four tensor maps picked per "
                    "direction, head views read in place; f32: CUDA-core "
                    "flash loop",
             device_ms=dev_b, library_device_ms=dev_b_lib,
             sass=sass.get("cross_attention")),
        row_c,
        dict(name="attention_fwd", route="cuda",
             source="ei_nexus_tpu_torch/csrc/attention_fwd.cu",
             replaces="ei_nexus_tpu/ops/pallas_attention.py:274",
             max_abs_err=fused_errs[torch.bfloat16][0],
             max_abs_err_f32=fused_errs[torch.float32][0],
             ms=t_d, plain_ms=t_d_plain, bound_ms=b_d, bound_by=by_d,
             library_ms=t_d_lib,
             design="bf16: pack pass (the self-attention's stride-3 v, "
                    "handed on to F) then the TMA + wgmma warp-specialised "
                    "flash loop of A, 128 rows a block in two consumer "
                    "warpgroups, with an epilogue writing each row's max "
                    "and sum of exp(s - max) for F; f32: CUDA-core flash "
                    "loop",
             loop_ms=_sum_ms(dev_d_all, "sm90_kernel"),
             pack_ms=_sum_ms(dev_d_all, "attention_pack"),
             ms_cross=t_d_cross, device_ms_cross=dev_d_cross,
             device_ms=dev_d, library_device_ms=dev_d_lib,
             sass=sass.get("attention_fwd")),
        dict(name="attention_bwd", route="cuda",
             source="ei_nexus_tpu_torch/csrc/attention_bwd.cu",
             replaces="ei_nexus_tpu/ops/pallas_attention.py:349",
             max_abs_err=fused_errs[torch.bfloat16][1],
             max_abs_err_f32=fused_errs[torch.float32][1],
             rel_err=fused_errs[torch.bfloat16][3],
             rel_err_f32=fused_errs[torch.float32][3],
             ms=t_f, plain_ms=t_f_plain, bound_ms=b_f, bound_by=by_f,
             library_ms=t_f_lib,
             design="bf16: c pass, pack pass (what the plan packs; none "
                    "on the main path, where F reads the v D packed), then "
                    "one TMA + wgmma warp-specialised launch of dK/dV "
                    "blocks "
                    "(64 keys, K and V resident, Q and dO streamed) and dQ "
                    "blocks (64 queries, K and V streamed), no atomics, P "
                    "from D's row max and sum; f32: one warp a row",
             device_ms=dev_f, library_device_ms=dev_f_lib,
             c_pass_ms=f_split["c pass"], pack_ms=f_split["pack"],
             loop_ms=f_split["loop"],
             dkdv_blocks_ms=f_split["dK/dV blocks alone"],
             dq_blocks_ms=f_split["dQ blocks alone"],
             sass=sass.get("attention_bwd")),
        # ms: the rot call at block_q 64, as the self layers run it
        dict(name="qblock_attention", route="cuda",
             source="ei_nexus_tpu_torch/csrc/qblock_attention.cu",
             replaces="ei_nexus_tpu/ops/pallas_attention.py:83",
             replaces_also="ei_nexus_tpu/ops/pallas_attention.py:70",
             max_abs_err=qblock_errs[torch.bfloat16][0],
             max_abs_err_f32=qblock_errs[torch.float32][0],
             ms=t_e["rot", 64], ms_rot_free=t_e["rot-free", 64],
             ms_block_q128=t_e["rot", 128],
             ms_block_q128_rot_free=t_e["rot-free", 128],
             plain_ms=t_e_plain, bound_ms=b_e, bound_by=by_e,
             library_ms=t_a_lib,
             design="bf16: the Hopper loop of A with block_q 64 (one "
                    "consumer warpgroup) or 128 (two); the rotary calls "
                    "packed first, rot-free head views read by TMA in "
                    "place; f32: CUDA-core flash loop",
             pack_ms=_sum_ms(dev_e["rot", 64], "attention_pack"),
             device_ms=_sum_ms(dev_e["rot", 64]),
             device_ms_rot_free=_sum_ms(dev_e["rot-free", 64]),
             device_ms_block_q128=_sum_ms(dev_e["rot", 128]),
             device_ms_block_q128_rot_free=_sum_ms(dev_e["rot-free", 128]),
             library_device_ms=_sum_ms(dev_a_lib),
             sass=sass.get("qblock_attention")),
        # ms: (8, 4, 1024, 64), the flagship; *_2048: 2048 tokens
        dict(name="flash_attention", route="cuda",
             source="ei_nexus_tpu_torch/csrc/flash_segment.cu",
             replaces="jax/experimental/pallas/ops/tpu/flash_attention.py:"
                      "758 (via ei_nexus_tpu/models/lightglue.py:141)",
             max_abs_err=flash_errs[torch.bfloat16][0],
             max_abs_err_f32=flash_errs[torch.float32][0],
             ms=t_g[n0], plain_ms=t_g_plain[n0], bound_ms=b_g[n0][0],
             bound_by=b_g[n0][1], library_ms=t_g_lib[n0],
             design="bf16: pack pass (the self-attention's stride-3 v) then "
                    "the TMA + wgmma warp-specialised flash loop of A in "
                    "its segment mode, 128 rows a block, the key ids "
                    "written beside each K/V tile by the producer, the "
                    "query ids in registers; f32: CUDA-core flash loop",
             loop_ms=g_split[n0][0], pack_ms=g_split[n0][1],
             device_ms=dev_g[n0], library_device_ms=dev_g_lib[n0],
             ms_2048=t_g[n1], plain_ms_2048=t_g_plain[n1],
             bound_ms_2048=b_g[n1][0], library_ms_2048=t_g_lib[n1],
             device_ms_2048=dev_g[n1], loop_ms_2048=g_split[n1][0],
             library_device_ms_2048=dev_g_lib[n1],
             sass=sass.get("flash_segment")),
    ]
    for r in rows:
        print(f"[kernels] {r['name']}: {r['ms']:.4f} ms (plain "
              f"{r['plain_ms']:.4f}, library {r['library_ms']}, bound "
              f"{r['bound_ms']:.4f} by {r['bound_by']}); device "
              f"{r['device_ms']:.4f} ms (library {r['library_device_ms']})")
    return rows


# ---------------------------------------------------------------------------
# phase 3: the main path at full width
# ---------------------------------------------------------------------------


def flagship_inputs(B: int = 8, max_events: int = 1 << 17):
    """The flagship's bursty event streams and frames on the card."""
    from ei_nexus_tpu_torch.data.synth import bursty_event_batch
    from ei_nexus_tpu_torch.flagship import flagship_config
    _, (H, W, _) = flagship_config()
    rng = np.random.default_rng(0)
    ev = bursty_event_batch(rng, B, int(max_events * 0.95), max_events, H, W)
    image = rng.uniform(0, 255, (B, H, W, 1)).astype(np.float32)
    return ({k: torch.as_tensor(v).cuda() for k, v in ev.items()},
            torch.as_tensor(image).cuda())


def phase_forward(tag: str, want: dict, want_packs: int,
                  attention_impl: str = "auto", block_q: int = 0):
    """The flagship EIM forward at full width with LightGlue's attention
    taken as `attention_impl` / `block_q` (`build_flagship`'s options):
    launch counts (and the Hopper loops' pack passes) read around one forward
    and held to `want` and `want_packs`, output checks, then latency (one
    forward at a time) and back-to-back rate. Returns (launches, ms per
    forward back to back, B, the forward)."""
    from ei_nexus_tpu_torch.flagship import build_flagship
    from ei_nexus_tpu_torch.ops.attention_kernels import hopper_attention
    from ei_nexus_tpu_torch.train.steps import batch_representation

    model, (H, W, bins) = build_flagship(
        dtype="bfloat16", generator=torch.Generator().manual_seed(0),
        attention_impl=attention_impl, block_q=block_q)
    ev, image = flagship_inputs()
    B = image.shape[0]

    def forward():
        rep, mask = batch_representation(ev, "VoxelGrid", bins, H, W)
        return model(rep, image, mask)

    counters = kernel_counters()
    with torch.inference_mode():
        for c in counters.values():
            c.launches = 0
        hopper_attention.packs = 0
        f0, f1, m = forward()
        torch.cuda.synchronize()
        launches = {n: c.launches for n, c in counters.items()}
        packs = hopper_attention.packs
        print(f"[{tag}] launches in one forward: {launches}; pack passes "
              f"of the Hopper loops (A, B, E, G): {packs}")
        want = {n: want.get(n, 0) for n in counters}
        require(launches == want, f"launch counts {launches} != {want}")
        require(packs == want_packs, f"{packs} pack passes != {want_packs}")
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
        print(f"[{tag}] valid keypoints {n_valid} of {B * K} per side, "
              f"{n_match} matches")
        require(n_match >= 1, "no valid match")

        torch.cuda.reset_peak_memory_stats()
        per_fwd, median, host_ms = time_calls(forward)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"[{tag}] forward (voxelize + EIM) B={B}: latency median "
          f"{median:.3f} ms over 10 synchronized forwards (CUDA events); "
          f"back to back {per_fwd:.3f} ms per forward over 10 (CUDA events; "
          f"host clock {host_ms:.3f} ms), {B / per_fwd * 1e3:.2f} pairs/s; "
          f"peak memory {peak_gb:.2f} GB")
    return launches, per_fwd, B, forward


def time_calls(fn, n: int = 10):
    """(ms per call back to back, median ms of single synchronized calls,
    host-clock ms per call back to back), CUDA events, after 2 warm-up
    calls."""
    for _ in range(2):
        fn()
    samples = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        samples.append(start.elapsed_time(end))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / n
    return start.elapsed_time(end) / n, float(np.median(samples)), host_ms


# ---------------------------------------------------------------------------
# phase 4: the stage-2 training step at full width
# ---------------------------------------------------------------------------

# the counters of every kernel, by the name the JSON line gives it
def kernel_counters():
    from ei_nexus_tpu_torch.ops import attention_kernels as ak
    from ei_nexus_tpu_torch.ops import nms_kernel as nk
    from ei_nexus_tpu_torch.ops import flash_kernel as fk
    return {"self_attention_rot": ak.self_attention,
            "cross_attention_bidir": ak.cross_attention_bidir,
            "nms_rounds": nk.nms_rounds,
            "attention_fwd": ak.attention_fwd,
            "attention_bwd": ak.attention_bwd,
            "qblock_attention": ak.qblock_attention,
            "flash_attention": fk.flash_attention}


def to_cuda(batch):
    """A stage-2 batch of numpy arrays -> the same structure on the card."""
    data0, data1, T01, T10 = batch
    dev = {k: torch.as_tensor(v).cuda() for k, v in data0.items()}
    return (dev, {k: torch.as_tensor(v).cuda() for k, v in data1.items()},
            torch.as_tensor(T01).cuda(), torch.as_tensor(T10).cuda())


def phase_stage2(tag: str = "stage2", built=None):
    """The stage-2 step at full width, B=8: the flagship's
    (`build_stage2_flagship`), or `built` = (model on the card with
    LightGlue's training heads, (H, W, bins)). Returns (launches, ms per
    step back to back, peak GB)."""
    from ei_nexus_tpu_torch.data.synth import stage2_batch
    from ei_nexus_tpu_torch.flagship import (build_stage2_flagship,
                                             stage2_train_state)
    from ei_nexus_tpu_torch.ops.attention_kernels import hopper_attention
    from ei_nexus_tpu_torch.train.steps import make_stage2_train_step

    B, max_events = 8, 1 << 17
    model, (H, W, bins) = built or build_stage2_flagship(
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
    hopper_attention.packs = 0
    fill.manual_seed(1)
    info = step(state, batch, fill)
    torch.cuda.synchronize()
    launches = {n: c.launches for n, c in counters.items()}
    packs = hopper_attention.packs
    print(f"[{tag}] launches in one step: {launches}; pack passes of D "
          f"and F: {packs}")
    want = {n: 0 for n in counters}
    want.update(nms_rounds=2, attention_fwd=36, attention_bwd=36)
    require(launches == want, f"launch counts {launches} != {want}")
    # D packs the self-attention's stride-3 v (18 calls) and hands the copy
    # to F; the rotated q, k, the cross-attention's head views and dO are
    # read in place, so F packs nothing
    require(packs == 18, f"{packs} pack passes in one step != 18")
    loss1, gnorm = float(info["loss"]), float(info["grad_norm"])
    require(np.isfinite(loss1) and np.isfinite(gnorm) and gnorm > 0,
            f"loss {loss1}, grad_norm {gnorm}")
    print(f"[{tag}] step 1: loss {loss1:.6f}, grad_norm {gnorm:.6f}, "
          f"gt_matches {float(info['gt_matches']):.2f}")
    for _ in range(10):
        fill.manual_seed(1)     # the same batch and the same fill
        info = step(state, batch, fill)
    loss11 = float(info["loss"])
    print(f"[{tag}] loss after 10 more updates on the same batch and "
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
    print(f"[{tag}] {len(frozen)} frozen tensors ({n_stats} BatchNorm "
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
    print(f"[{tag}] step B={B}: {per_step:.3f} ms per step back to back "
          f"over {n} (CUDA events; host clock {host_ms:.3f} ms), "
          f"{1e3 / per_step:.3f} steps/s; single steps min "
          f"{min(each):.3f}, median {float(np.median(each)):.3f}, max "
          f"{max(each):.3f} ms; peak memory {peak_gb:.2f} GB")
    return launches, per_step, peak_gb


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


# ---------------------------------------------------------------------------
# phase 6: the pose tail
# ---------------------------------------------------------------------------

POSE_B, POSE_SLOTS, POSE_VALID = 8, 1024, 614   # 60% of the slots valid
POSE_THRESH = 1.0 / 199.0   # 1 px at the flagship's focal length, 199 px


def make_scene(rng, n, noise=0.0, outlier_frac=0.0, depth=4.0):
    """A random two-view scene of n correspondences in normalized
    coordinates (the recipe of tests/test_fivepoint.py:make_scene): a
    moderate rotation, a unit translation, points 4 m ahead, Gaussian
    noise, the first outlier_frac of side 1 replaced by uniform points.
    Returns (p0, p1, R)."""
    A = rng.normal(size=(3, 3))
    Q, _ = np.linalg.qr(A)
    if np.linalg.det(Q) < 0:
        Q[:, 0] *= -1
    Q = np.eye(3) + 0.3 * (Q - np.eye(3))
    U, _, Vt = np.linalg.svd(Q)
    Q = U @ Vt
    t = rng.normal(size=3)
    t /= np.linalg.norm(t)
    P = rng.uniform(-1.5, 1.5, (n, 3)) + np.array([0, 0, depth])
    p0 = P[:, :2] / P[:, 2:]
    P1 = P @ Q.T + t
    p1 = P1[:, :2] / P1[:, 2:]
    if noise:
        p0 = p0 + rng.normal(0, noise, p0.shape)
        p1 = p1 + rng.normal(0, noise, p1.shape)
    n_out = int(n * outlier_frac)
    if n_out:
        p1[:n_out] = rng.uniform(-0.5, 0.5, (n_out, 2))
    return p0, p1, Q


def rotation_error_deg(R: np.ndarray, R_true: np.ndarray) -> float:
    c = np.clip((np.trace(R.T @ R_true) - 1) / 2, -1, 1)
    return float(np.degrees(np.arccos(c)))


def count_syncs(fn):
    """(fn's result, the host syncs PyTorch reports during one call, the
    {file:line: count} of the port's lines that made them: the innermost
    frame of the port or of this script when the sync is reported)."""
    import traceback
    import warnings
    where = {}

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        frames = [f for f in traceback.extract_stack()[:-1]   # not this one
                  if "ei_nexus_tpu_torch" in f.filename
                  or f.filename.endswith("chip_smoke.py")]
        f = frames[-1] if frames else None
        at = (f"{os.path.relpath(f.filename)}:{f.lineno}" if f
              else f"{filename}:{lineno}")
        where[at] = where.get(at, 0) + 1

    # switching the mode reports a sync of its own: only fn's are recorded
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = record
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return out, sum(where.values()), where


def phase_pose_check():
    """Eight two-view scenes (1024 slots, 60% valid, noise 1e-3, 20%
    outliers; the last pair has 3 valid slots) posed on the CPU and on the
    card with the same injected samples. float64: R and t agree to 1e-4,
    n_inliers to +-1 (the card's QR returns another nullspace basis, so the
    five-point candidates come in another order). float32, the serving
    type: the agreement is printed (an ill-conditioned minimal sample's
    candidates move under rounding alone) and both devices are held to the
    truth, < 1 degree on the solvable pairs."""
    from ei_nexus_tpu_torch.metrics.ransac import (estimate_pose_batch,
                                                   sample_indices)
    # scenes of seed 2: their worst rotation error from these samples is
    # about 0.5 degree on both devices, which leaves the 1-degree check
    # room for the card's other candidate order in float32
    rng = np.random.default_rng(2)
    B, N = POSE_B, POSE_SLOTS
    p0 = np.zeros((B, N, 2))
    p1 = np.zeros((B, N, 2))
    mask = np.zeros((B, N), bool)
    truth = []
    for b in range(B):
        n = POSE_VALID if b < B - 1 else 3
        a0, a1, R = make_scene(rng, n, noise=1e-3, outlier_frac=0.2)
        p0[b, :n], p1[b, :n], mask[b, :n] = a0, a1, True
        truth.append(R)
    indices = sample_indices(torch.from_numpy(mask), 128, "5pt",
                             torch.Generator().manual_seed(0))
    report = {}
    for dtype in (torch.float64, torch.float32):
        args = [torch.from_numpy(p0).to(dtype), torch.from_numpy(p1).to(dtype),
                torch.from_numpy(mask), torch.full((B,), POSE_THRESH,
                                                   dtype=dtype)]
        R_c, t_c, _, n_c = estimate_pose_batch(*args, indices=indices)
        dev = estimate_pose_batch(*(a.cuda() for a in args),
                                  indices=tuple(i.cuda() for i in indices))
        torch.cuda.synchronize()
        require(all(x.device.type == "cuda" for x in dev),
                "the pose tail left the card")
        R_g, t_g, _, n_g = (x.cpu() for x in dev)
        solv = slice(0, B - 1)
        e_R = max_err(R_g[solv], R_c[solv])
        e_t = max_err(t_g[solv], t_c[solv])
        e_n = int((n_g - n_c).abs().max())
        errs = [rotation_error_deg(R.double().numpy(), truth[b])
                for R_all in (R_c, R_g) for b, R in enumerate(R_all[solv])]
        print(f"[pose] {dtype}: card vs CPU max|R err| {e_R:.3e}, max|t "
              f"err| {e_t:.3e}, n_inliers diff {e_n} (n {n_g.tolist()}); "
              f"rotation error vs truth max {max(errs):.3f} deg over "
              f"{B - 1} solvable pairs on both devices")
        require(all(torch.isfinite(x).all() for x in (R_g, t_g)),
                "non-finite pose")
        require(int(n_g[B - 1]) <= 3, "3 valid slots gave more inliers")
        require(max(errs) < 1.0, f"rotation error {max(errs):.3f} deg")
        if dtype == torch.float64:
            require(e_R <= 1e-4 and e_t <= 1e-4 and e_n <= 1,
                    f"pose on the card differs from the CPU: R {e_R:.3e}, "
                    f"t {e_t:.3e}, n {e_n}")
        report[str(dtype)] = (e_R, e_t, e_n, max(errs))
    return report


def phase_serving_pose(forward, B: int):
    """The flash forward chained with the pose tail as bench.py:239-258
    chains them: matched positions in the matcher's slots, yx -> xy, focal
    199, principal point (W/2, H/2), threshold 1/199, 5-point, 128 samples
    from a generator on the card. Returns (ms per served batch back to
    back, pose ms per batch, host syncs of one pose call)."""
    from ei_nexus_tpu_torch.flagship import flagship_config
    from ei_nexus_tpu_torch.metrics.ransac import estimate_pose_batch
    _, (H, W, _) = flagship_config()
    fx = 199.0
    cc = torch.tensor([W / 2.0, H / 2.0], device="cuda")
    ff = torch.tensor([fx, fx], device="cuda")
    thr = torch.full((B,), 1.0 / fx, device="cuda")
    gen = torch.Generator(device="cuda")

    def pose_of(out):
        f0, f1, m = out
        m0 = m["matches0"].long()
        sel = m0 > -1
        idx = m0.clamp(0, m0.shape[-1] - 1)
        mf0 = m.get("input_feats0", f0)
        mf1 = m.get("input_feats1", f1)
        p0 = mf0["sparse_positions"][..., :2].flip(-1)
        p1 = torch.gather(mf1["sparse_positions"][..., :2].flip(-1), 1,
                          idx[..., None].expand(-1, -1, 2))
        gen.manual_seed(0)
        return estimate_pose_batch(((p0 - cc) / ff).float(),
                                   ((p1 - cc) / ff).float(), sel, thr,
                                   generator=gen)

    with torch.inference_mode():
        out = forward()
        pose_of(out)    # the first call copies the solver's tables once
        torch.cuda.synchronize()
        (R, t, _, n), syncs, where = count_syncs(lambda: pose_of(out))
        torch.cuda.synchronize()
        require(bool(torch.isfinite(R).all() and torch.isfinite(t).all()),
                "non-finite pose on the serving path")
        print(f"[serve] pose of one batch: n_inliers {n.tolist()}, "
              f"{syncs} host syncs in one pose call "
              f"(torch.cuda.set_sync_debug_mode), made at {where}")
        pose_ms, pose_median, _ = time_calls(lambda: pose_of(out))
        per_batch, median, host_ms = time_calls(lambda: pose_of(forward()))
    print(f"[serve] flash forward + pose B={B}: {per_batch:.3f} ms per batch "
          f"back to back over 10 (CUDA events; host clock {host_ms:.3f} "
          f"ms), {B / per_batch * 1e3:.2f} pairs/s, latency median "
          f"{median:.3f} ms; the pose tail alone {pose_ms:.3f} ms per batch "
          f"back to back (median {pose_median:.3f} ms single)")
    return per_batch, pose_ms, syncs


# ---------------------------------------------------------------------------
# phase 7: the loader-fed forward (the data path feeding the main path)
# ---------------------------------------------------------------------------

LOADER_B, LOADER_BATCHES, LOADER_WORKERS = 8, 12, 4
LOADER_SLOTS = 1 << 18            # configs/dataset/mvsec.yaml max_events
LOADER_EVENTS = (27000, 55000)    # mini-MVSEC median and max a window


class LoaderPairs:
    """A map-style dataset of the readers' sample contract (MVSEC's
    single mode: (data0, data1 = data0, T01 = I, T10 = I)). Sample i is
    drawn from (seed, i): a bursty window of 27k-55k events padded to
    262,144 slots, a 260x346x1 float32 frame, its stamp, K and pose."""

    def __init__(self, n: int, H: int, W: int, seed: int = 0):
        self.n, self.H, self.W, self.seed = n, H, W, seed

    def __len__(self):
        return self.n

    def events(self, i: int) -> int:
        """Sample i's event count (the first draw of its generator)."""
        rng = np.random.default_rng([self.seed, i])
        return int(rng.integers(LOADER_EVENTS[0], LOADER_EVENTS[1] + 1))

    def __getitem__(self, i):
        from ei_nexus_tpu_torch.data.representations import pad_events
        from ei_nexus_tpu_torch.data.synth import bursty_events
        rng = np.random.default_rng([self.seed, i])
        n = int(rng.integers(LOADER_EVENTS[0], LOADER_EVENTS[1] + 1))
        x, y, t, p = bursty_events(rng, n, self.H, self.W)
        xp, yp, tp, pp, valid = pad_events(x, y, t, p, LOADER_SLOTS)
        pose = np.eye(4, dtype=np.float32)
        pose[:3, 3] = rng.normal(0, 0.1, 3)
        view = {"events_x": xp, "events_y": yp, "events_t": tp,
                "events_p": pp, "events_valid": valid,
                "image": rng.uniform(0, 255, (self.H, self.W, 1)).astype(
                    np.float32),
                "image_ts": np.float32(0.4 * i),
                "K": np.array([[199.0, 0, self.W / 2], [0, 199.0, self.H / 2],
                               [0, 0, 1]], np.float32),
                "pose": pose}
        eye = np.eye(4, dtype=np.float32)
        return view, view, eye, eye


def phase_loader_forward():
    """The "auto" flagship fed by the data path: a DataLoader (4 threads)
    over `LoaderPairs`, each batch through `compact_event_view(keep=
    ("image",))` with the C++ encoder (required: the phase fails if it
    does not build) and `device_prefetch` with a `PinnedPut`, then the
    voxel grid and the forward (`serve.serve_loader`, which takes the C++
    encoder where it builds, as the JAX package does). Checks: the decode
    on the card bit-equal to round(v * 64) / 64 of the same encoder on
    the host; the matches of a batch fed as the wire equal to those of the
    same batch fed as decoded float arrays (deterministic index_add_ for
    both); launches a batch A 18, B 9, C 2 over the timed pass. Timed as
    bench.py's end-to-end pass: a warm pass, a timed pass, a host-only
    pass; the host's stages of one batch alone (encode with each encoder,
    the pinned put and its copy). Returns (pairs/s, host-only pairs/s, the
    host share in % (host-only wall over served wall), the buckets taken,
    the stages' host ms)."""
    from ei_nexus_tpu_torch import native
    from ei_nexus_tpu_torch.data.pipeline import DataLoader, PinnedPut
    from ei_nexus_tpu_torch.flagship import build_flagship
    from ei_nexus_tpu_torch.serve import serve_host_only, serve_loader
    from ei_nexus_tpu_torch.train.steps import (EVENT_BUCKETS,
                                                EVENT_COORD_SCALE,
                                                _decode_event_view,
                                                batch_representation,
                                                compact_event_view)

    require(native.lib() is not None,
            "the native event encoder did not build on this machine")
    model, (H, W, bins) = build_flagship(
        dtype="bfloat16", generator=torch.Generator().manual_seed(0))
    B = LOADER_B
    data = LoaderPairs(B * LOADER_BATCHES, H, W)
    loader = DataLoader(data, batch_size=B, drop_last=True,
                        num_workers=LOADER_WORKERS)
    # the wire length each batch takes (its largest window's bucket)
    taken = [min(b for b in EVENT_BUCKETS if b >= max(
        data.events(i) for i in range(k, k + B)))
        for k in range(0, len(data), B)]
    buckets = sorted(set(taken))

    # one batch: decode on the card against the host, wire-fed matches
    # against float-fed matches
    first = next(iter(loader))[0]
    enc = compact_event_view(first, keep=("image",), native=True)
    put = PinnedPut("cuda")
    dev = _decode_event_view(put(enc), "cuda")
    L = enc["events_xq"].shape[-1]
    require(L == taken[0], f"the first batch's wire has {L} columns, "
            f"not {taken[0]}")
    for key in ("events_x", "events_y"):
        v = first[key][:, :L].astype(np.float64) * EVENT_COORD_SCALE
        want = (np.floor(v + 0.5) / EVENT_COORD_SCALE).astype(np.float32)
        require(torch.equal(dev[key].cpu(), torch.from_numpy(want)),
                f"{key} decoded on the card differs from the host's")
    valid = np.arange(L)[None, :] < first["events_valid"].sum(-1)[:, None]
    require(torch.equal(dev["events_valid"].cpu(), torch.from_numpy(valid))
            and bool((first["events_valid"][:, L:] == 0).all()),
            "validity decoded on the card differs from the host's")
    floats = {k: torch.from_numpy(np.ascontiguousarray(a)).cuda()
              for k, a in (("events_x", dev["events_x"].cpu().numpy()),
                           ("events_y", dev["events_y"].cpu().numpy()),
                           ("events_t", first["events_t"][:, :L]),
                           ("events_p", first["events_p"][:, :L]),
                           ("events_valid", valid))}
    image = torch.from_numpy(first["image"]).cuda()

    def matches(view, img):
        rep, mask = batch_representation(view, "VoxelGrid", bins, H, W)
        return model(rep, img, mask)[2]["matches0"]

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with torch.inference_mode():
            wire = put(enc)
            m_wire = matches(wire, wire["image"])
            m_float = matches(floats, image)
    finally:
        torch.use_deterministic_algorithms(False)
    put.synchronize()
    require(torch.equal(m_wire, m_float),
            "wire-fed matches differ from float-fed matches")
    print(f"[loader] decode on the card bit-equal to the host's "
          f"round(v*64)/64 (C++ encoder), wire of {L} columns; wire-fed "
          f"matches0 equal float-fed ({int((m_wire > -1).sum())} matches)")

    # the host's stages of one batch, each alone (host clock, median of 5)
    def host_ms(fn):
        out = []
        for _ in range(5):
            t = time.perf_counter()
            fn()
            out.append((time.perf_counter() - t) * 1e3)
        return float(np.median(out))

    def put_and_wait():
        put(enc)
        put.synchronize()

    wire_bytes = sum(np.asarray(v).nbytes for v in enc.values())
    float_bytes = sum(np.asarray(first[k]).nbytes for k in (
        "events_x", "events_y", "events_t", "events_p", "events_valid",
        "image"))
    stages = {"encode_cpp_ms": host_ms(lambda: compact_event_view(
                  first, keep=("image",), native=True)),
              "encode_numpy_ms": host_ms(lambda: compact_event_view(
                  first, keep=("image",), native=False)),
              "put_ms": host_ms(put_and_wait)}
    print(f"[loader] one batch: encode {stages['encode_cpp_ms']:.3f} ms "
          f"(C++), {stages['encode_numpy_ms']:.3f} ms (numpy); pinned put "
          f"and copy {stages['put_ms']:.3f} ms for {wire_bytes / 1e6:.2f} MB "
          f"of wire ({float_bytes / 1e6:.2f} MB as float arrays)")

    serve_loader(model, loader, bins, H, W)    # warm
    counters = kernel_counters()
    for c in counters.values():
        c.launches = 0
    wall, pairs = serve_loader(model, loader, bins, H, W)
    launches = {n: c.launches for n, c in counters.items()}
    host_wall, host_pairs = serve_host_only(loader)
    n_batches = pairs // B
    per_batch = {n: c / n_batches for n, c in launches.items() if c}
    print(f"[loader] launches over the timed pass of {n_batches} batches: "
          f"{launches}; a batch {per_batch}")
    want = {"self_attention_rot": 18, "cross_attention_bidir": 9,
            "nms_rounds": 2}
    want = {n: want.get(n, 0) * n_batches for n in counters}
    require(launches == want, f"launch counts {launches} != {want}")
    require(pairs == host_pairs == B * LOADER_BATCHES, "pairs served")
    rate, host_rate = pairs / wall, host_pairs / host_wall
    share = 100 * host_wall / wall
    print(f"[loader] loader-fed forward (auto) B={B}, {LOADER_WORKERS} "
          f"loader threads, C++ encoder, buckets taken {sorted(buckets)}: "
          f"{rate:.2f} pairs/s ({wall:.3f} s for {pairs} pairs); host only "
          f"(loader + encode) {host_rate:.2f} pairs/s ({host_wall:.3f} s); "
          f"host share {share:.1f}%")
    return rate, host_rate, share, buckets, stages


# ---------------------------------------------------------------------------
# phase 8: the stage-1 model's MNN forward
# ---------------------------------------------------------------------------


def mnn_config(tiny: bool = False, dtype: str = "bfloat16"):
    """The stage-1 model as tools/bench_train.py:47-56 builds it: the
    flagship with a trainable event extractor and the frozen MNN matcher
    at max_points_num K."""
    from ei_nexus_tpu_torch.flagship import flagship_config
    from ei_nexus_tpu_torch.models.eim import MatcherConfig
    cfg, shape = flagship_config(tiny, dtype)
    return dataclasses.replace(
        cfg,
        event_extractor=dataclasses.replace(cfg.event_extractor,
                                            freeze=False),
        matcher=MatcherConfig(type="MNN", freeze=True,
                              max_points_num=cfg.matcher.max_points_num)
    ), shape


def phase_mnn_forward():
    """The stage-1 model at inference, full width, B=8 (C 2 launches a
    forward, no attention kernel), latency and pairs/s; then the tiny
    float32 config on the CPU and on the card (fixed 4 NMS rounds on
    both): matches equal. Returns (ms per forward back to back, B)."""
    from ei_nexus_tpu_torch.models.eim import EIM
    from ei_nexus_tpu_torch.models.layers import init_parameters
    from ei_nexus_tpu_torch.train.steps import batch_representation

    cfg, (H, W, bins) = mnn_config()
    model = EIM(cfg)
    init_parameters(model, torch.Generator().manual_seed(0))
    model = model.cuda().eval()
    ev, image = flagship_inputs()
    B = image.shape[0]

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
        want = {n: 2 if n == "nms_rounds" else 0 for n in counters}
        print(f"[mnn] launches in one forward: {launches}")
        require(launches == want, f"launch counts {launches} != {want}")
        K = cfg.matcher.max_points_num
        require(m["matches0"].shape == (B, K)
                and m["log_assignment"].shape == (B, K + 1, K + 1),
                "MNN match shapes")
        require(torch.isfinite(m["log_assignment"]).all(),
                "non-finite log-assignment")
        n_match = int((m["matches0"] > -1).sum())
        print(f"[mnn] {n_match} mutual matches of {B * K} slots")
        require(n_match >= 1, "no MNN match")
        per_fwd, median, host_ms = time_calls(forward)
    print(f"[mnn] stage-1 (MNN) forward B={B}: latency median {median:.3f} "
          f"ms; back to back {per_fwd:.3f} ms per forward (CUDA events; "
          f"host clock {host_ms:.3f} ms), {B / per_fwd * 1e3:.2f} pairs/s")

    # the tiny config on the CPU and on the card
    from ei_nexus_tpu_torch.data.synth import bursty_event_batch
    tcfg, (h, w, tb) = mnn_config(tiny=True, dtype="float32")
    kp = dataclasses.replace(tcfg.event_extractor.keypoints,
                             nms_impl="pallas")
    tcfg = dataclasses.replace(
        tcfg,
        event_extractor=dataclasses.replace(tcfg.event_extractor,
                                            keypoints=kp),
        image_extractor=dataclasses.replace(tcfg.image_extractor,
                                            keypoints=kp))
    cpu_model = EIM(tcfg).eval()
    init_parameters(cpu_model, torch.Generator().manual_seed(3))
    gpu_model = copy.deepcopy(cpu_model).cuda()
    rng = np.random.default_rng(3)
    tev = bursty_event_batch(rng, 4, 3000, 4096, h, w)
    timg = torch.as_tensor(rng.uniform(0, 255, (4, h, w, 1)).astype(
        np.float32))
    out = {}
    with torch.inference_mode():
        for dev, mod in (("cpu", cpu_model), ("cuda", gpu_model)):
            rep, mask = batch_representation(tev, "VoxelGrid", tb, h, w,
                                             device=dev)
            out[dev] = [x for x in mod(rep, timg.to(dev), mask)]
    (e_c, i_c, m_c), (e_g, i_g, m_g) = out["cpu"], out["cuda"]
    same_kp = all(torch.equal(a["sparse_positions"][..., :2],
                              b["sparse_positions"][..., :2].cpu())
                  for a, b in ((e_c, e_g), (i_c, i_g)))
    n_c = int((m_c["matches0"] > -1).sum())
    print(f"[mnn] tiny config CPU vs card: keypoints equal {same_kp}, "
          f"{n_c} matches on the CPU")
    for k in ("matches0", "matches1"):
        require(torch.equal(m_c[k], m_g[k].cpu()),
                f"MNN {k} on the card differ from the CPU")
    return per_fwd, B


# ---------------------------------------------------------------------------
# phase 9: stage-1 training (event-extractor distillation)
# ---------------------------------------------------------------------------


def stage1_batch(B: int = 8, max_events: int = 1 << 17):
    """The stage-1 step's batch on the card: the flagship's bursty events
    (95% of the slots full) and frames, as (data0,)."""
    from ei_nexus_tpu_torch.data.synth import bursty_event_batch
    from ei_nexus_tpu_torch.flagship import stage1_config
    _, (H, W, _) = stage1_config()
    rng = np.random.default_rng(0)
    view = bursty_event_batch(rng, B, int(max_events * 0.95), max_events,
                              H, W)
    view["image"] = rng.uniform(0, 255, (B, H, W, 1)).astype(np.float32)
    return ({k: torch.as_tensor(v).cuda() for k, v in view.items()},)


def phase_stage1():
    """The flagship stage-1 step at full width (`build_stage1_flagship`:
    event VGG trained, SuperPoint and MNN frozen, the losses of
    tools/bench_train.py:84-99, AdamW and the cosine schedule of
    configs/train/train_stage1.yaml; bf16, B=8): launch counts read around
    one step (no kernel: the step runs no NMS, top-k or attention, as the
    compiled JAX step does not), finite loss and terms, grad_norm > 0,
    SuperPoint bit-unchanged, every event-extractor parameter and running
    statistic changed, the loss lower after 10 more steps on the same
    batch, then steps/s over 24 steps back to back with the spread of
    single steps, and peak memory. Returns (launches, ms per step)."""
    from ei_nexus_tpu_torch.flagship import (STAGE1_LOSSES,
                                             build_stage1_flagship,
                                             stage1_train_state)
    from ei_nexus_tpu_torch.losses import build_losses
    from ei_nexus_tpu_torch.ops.attention_kernels import hopper_attention
    from ei_nexus_tpu_torch.train.steps import make_stage1_train_step

    model, (H, W, bins) = build_stage1_flagship(
        dtype="bfloat16", generator=torch.Generator().manual_seed(0))
    state = stage1_train_state(model, steps_per_epoch=100)
    batch = stage1_batch()
    B = batch[0]["image"].shape[0]
    step = make_stage1_train_step(build_losses(STAGE1_LOSSES), "VoxelGrid",
                                  bins, H, W)
    start = {k: v.clone() for k, v in model.state_dict().items()}

    counters = kernel_counters()
    for c in counters.values():
        c.launches = 0
    hopper_attention.packs = 0
    info = step(state, batch)
    torch.cuda.synchronize()
    launches = {n: c.launches for n, c in counters.items()}
    print(f"[stage1] launches in one step: {launches}; pack passes: "
          f"{hopper_attention.packs}")
    want = {n: 0 for n in counters}
    require(launches == want and hopper_attention.packs == 0,
            f"launch counts {launches} != {want}")
    vals = {k: float(v) for k, v in info.items()}
    require(all(np.isfinite(v) for v in vals.values())
            and vals["grad_norm"] > 0, f"step 1 info {vals}")
    require(set(vals) == {"loss", "extractor_keypoints_loss",
                          "extractor_descriptor_loss", "feature_loss",
                          "grad_norm", "dropped_splat_weight"},
            f"info keys {sorted(vals)}")
    print("[stage1] step 1: " + ", ".join(f"{k} {v:.6f}"
                                          for k, v in vals.items()))
    for _ in range(10):
        info = step(state, batch)
    loss11 = float(info["loss"])
    print(f"[stage1] loss after 10 more updates on the same batch: "
          f"{loss11:.6f} (step 1: {vals['loss']:.6f})")
    require(loss11 < vals["loss"], "the loss did not decrease")
    end = model.state_dict()
    frozen = [k for k in start if k.startswith("image_extractor.")]
    changed = [k for k in frozen if not torch.equal(start[k], end[k])]
    require(not changed, f"frozen tensors changed: {changed[:5]}")
    trained = [k for k in start if k.startswith("event_extractor.")]
    stats = [k for k in trained if k.endswith(("running_mean",
                                               "running_var"))]
    still = [k for k in trained if torch.equal(start[k], end[k])]
    print(f"[stage1] {len(frozen)} SuperPoint tensors bit-unchanged; "
          f"{len(trained) - len(still)} of {len(trained)} event-extractor "
          f"tensors changed ({len(stats)} of them BatchNorm running "
          f"statistics)")
    require(not still, f"event-extractor tensors unchanged: {still[:5]}")

    torch.cuda.reset_peak_memory_stats()
    n = 24
    events = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
    t0 = time.perf_counter()
    events[0].record()
    for i in range(n):
        step(state, batch)
        events[i + 1].record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / n
    each = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    per_step = events[0].elapsed_time(events[-1]) / n
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"[stage1] step B={B}: {per_step:.3f} ms per step back to back "
          f"over {n} (CUDA events; host clock {host_ms:.3f} ms), "
          f"{1e3 / per_step:.3f} steps/s; single steps min "
          f"{min(each):.3f}, median {float(np.median(each)):.3f}, max "
          f"{max(each):.3f} ms; peak memory {peak_gb:.2f} GB")
    return launches, per_step, (min(each), float(np.median(each)),
                                max(each)), peak_gb


def phase_stage1_cpu_vs_gpu():
    """One stage-1 step of the tiny float32 config (score and descriptor
    losses: its event width of 16 cannot meet SuperPoint's 128) on the CPU
    and on the card from the same weights and batch: loss (rel 1e-4),
    grad_norm (rel 1e-3), updated parameters (within 4 lr: Adam's first
    step moves a parameter by about lr whatever its gradient's size, so a
    near-zero gradient whose sign differs flips it), running statistics
    (1e-4), SuperPoint bit-unchanged on both."""
    from ei_nexus_tpu_torch.data.synth import bursty_event_batch
    from ei_nexus_tpu_torch.flagship import (STAGE1_LOSSES, STAGE1_LR,
                                             build_stage1_flagship,
                                             stage1_train_state)
    from ei_nexus_tpu_torch.losses import build_losses
    from ei_nexus_tpu_torch.train.steps import make_stage1_train_step

    cpu_model, (H, W, bins) = build_stage1_flagship(
        tiny=True, dtype="float32", device="cpu",
        generator=torch.Generator().manual_seed(4))
    gpu_model = copy.deepcopy(cpu_model).cuda()
    start = {k: v.clone() for k, v in cpu_model.state_dict().items()}
    rng = np.random.default_rng(4)
    view = bursty_event_batch(rng, 2, 3000, 4096, H, W)
    view["image"] = rng.uniform(0, 255, (2, H, W, 1)).astype(np.float32)
    losses = build_losses({k: v for k, v in STAGE1_LOSSES.items()
                           if k != "feature_loss"})
    step = make_stage1_train_step(losses, "VoxelGrid", bins, H, W)
    infos = {}
    for name, model in (("cpu", cpu_model), ("cuda", gpu_model)):
        infos[name] = {k: float(v) for k, v in
                       step(stage1_train_state(model), (view,)).items()}
    ic, ig = infos["cpu"], infos["cuda"]
    sc = cpu_model.state_dict()
    sg = {k: v.cpu() for k, v in gpu_model.state_dict().items()}
    e_loss = abs(ig["loss"] - ic["loss"]) / abs(ic["loss"])
    e_norm = abs(ig["grad_norm"] - ic["grad_norm"]) / ic["grad_norm"]
    stats = [k for k in sc if k.endswith(("running_mean", "running_var"))]
    e_stats = max(max_err(sg[k], sc[k]) for k in stats)
    e_par = max(max_err(sg[k], sc[k]) for k in sc
                if k.startswith("event_extractor.") and k not in stats)
    frozen_ok = all(torch.equal(sg[k], start[k]) and torch.equal(sc[k],
                                                                 start[k])
                    for k in sc if k.startswith("image_extractor."))
    print(f"[cpu-vs-gpu] stage-1 step: loss {ic['loss']:.6f} (cpu) vs "
          f"{ig['loss']:.6f} (card), rel {e_loss:.2e}; grad_norm "
          f"{ic['grad_norm']:.6f} vs {ig['grad_norm']:.6f}, rel "
          f"{e_norm:.2e}; updated parameters max|err| {e_par:.2e} (bound "
          f"{4 * STAGE1_LR:g}); running statistics max|err| {e_stats:.2e}; "
          f"SuperPoint unchanged on both: {frozen_ok}")
    require(e_loss <= 1e-4, f"stage-1 loss differs: rel {e_loss:.2e}")
    require(e_norm <= 1e-3, f"grad_norm differs: rel {e_norm:.2e}")
    require(e_par <= 4 * STAGE1_LR, f"parameters differ: {e_par:.2e}")
    require(e_stats <= 1e-4, f"running statistics differ: {e_stats:.2e}")
    require(frozen_ok, "a SuperPoint tensor changed")
    return e_loss, e_norm, e_par, e_stats


ENTRY_CONFIG = "configs/train_EIM_stage1_EC_SP_MNN.yaml"
SILK_ENTRY_CONFIG = "configs/train_EIM_stage1_EC_SiLK_MNN.yaml"
ENTRY_FRAMES = 216     # the [100:-100] crop leaves about 15 a sequence


def _entry_run(extra, data, out, config=ENTRY_CONFIG, timeout=600):
    """`python -m ei_nexus_tpu_torch.train_extractor` on the card over the
    rendered mini-EC; returns (its run directory, metrics rows, log text,
    wall seconds). Raises on a non-zero exit."""
    cmd = [sys.executable, "-m", "ei_nexus_tpu_torch.train_extractor",
           "--config", config] + extra + [
        f"dataset.data_path={data}", f"logger.output_dir={out}",
        "logger.status_freq=1"]
    t = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=timeout)
    wall = time.perf_counter() - t
    if proc.returncode != 0:
        print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
    require(proc.returncode == 0,
            f"train_extractor exited {proc.returncode}")
    run, = [p for p in os.listdir(out)
            if os.path.isdir(os.path.join(out, p))]
    run = os.path.join(out, run)
    with open(os.path.join(run, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    with open(os.path.join(run, "log.txt")) as f:
        log = f.read()
    return run, rows, log, wall


def render_mini_ec(root: str) -> float:
    """The six EC training sequences of a mini-EC (`data/mini_ec.py`,
    seeded) rendered under `root`; returns the seconds it took."""
    from ei_nexus_tpu_torch.data.ec import TRAIN_SEQUENCES
    from ei_nexus_tpu_torch.data.mini_ec import make_mini_ec

    t = time.perf_counter()
    counts = make_mini_ec(root, ENTRY_FRAMES, sequences=TRAIN_SEQUENCES)
    render_s = time.perf_counter() - t
    print(f"[entry] rendered the mini-EC's {len(counts)} training "
          f"sequences ({ENTRY_FRAMES} frames, {sum(counts.values())} "
          f"events) in {render_s:.1f} s")
    return render_s


def phase_stage1_entry(data: str, tmp: str, tag: str = "entry",
                       config: str = ENTRY_CONFIG, resume: bool = True):
    """The stage-1 entry point from disk, over the mini-EC rendered in
    `data`: `python -m ei_nexus_tpu_torch.train_extractor --config
    <config> --max-steps 4` on the card (the full-width EC config at its
    160x160 crops, B=8, 4 loader threads), its runs under `tmp`: exit 0,
    finite logged losses at steps 1-4, a `final` checkpoint at step 4;
    then, with `resume`, `--resume <final> --max-steps 6`: steps 5 and 6.
    Returns the entry's steady steps/s (its own log: steps 3 and 4, timed
    from the drain of step 1 to that of step 4) and the runs' process
    wall seconds."""
    run, rows, log, wall = _entry_run(["--max-steps", "4"], data,
                                      os.path.join(tmp, f"{tag}_runs"),
                                      config)
    require([r["step"] for r in rows] == [1, 2, 3, 4],
            f"logged steps {[r['step'] for r in rows]}")
    for r in rows:
        require(all(np.isfinite(v) for v in r.values()),
                f"non-finite logged values {r}")
    require("training at 160x160" in log, "not trained at the crop")
    final = os.path.join(run, "checkpoints", "final")
    ck = torch.load(os.path.join(final, "state.pt"), map_location="cpu",
                    weights_only=True)
    require(ck["step"] == 4, f"final checkpoint at step {ck['step']}")
    rate = _steady_rate(log)
    print(f"[{tag}] {config}: 4 steps in {wall:.1f} s (process wall): "
          f"losses " + ", ".join(f"{r['loss']:.5f}" for r in rows)
          + f"; steady {rate:.3f} steps/s")
    if not resume:
        return rate, (wall,)
    run2, rows2, log2, wall2 = _entry_run(
        ["--max-steps", "6", "--resume", final], data,
        os.path.join(tmp, f"{tag}_runs2"), config)
    require([r["step"] for r in rows2] == [5, 6],
            f"resumed at steps {[r['step'] for r in rows2]}")
    require("resumed from" in log2, "no resume in the log")
    ck2 = torch.load(os.path.join(run2, "checkpoints", "final",
                                  "state.pt"), map_location="cpu",
                     weights_only=True)
    require(ck2["step"] == 6, f"resumed final at step {ck2['step']}")
    print(f"[{tag}] resumed from step 4 to 6 in {wall2:.1f} s (process "
          f"wall): losses " + ", ".join(f"{r['loss']:.5f}" for r in rows2))
    return rate, (wall, wall2)


# ---------------------------------------------------------------------------
# phase 10: the SiLK family (cell-1 extractors)
# ---------------------------------------------------------------------------

NMS_CELL1_SHAPES = ((8, 260, 346), (8, 242, 328))   # padding 1 and 0


def _read_launches(fn, tag: str, want: dict, want_packs=None):
    """Run `fn` once with every kernel counter at 0, hold the launches
    (and the Hopper loops' pack passes) to `want`; returns (launches, the
    output)."""
    from ei_nexus_tpu_torch.ops.attention_kernels import hopper_attention
    counters = kernel_counters()
    for c in counters.values():
        c.launches = 0
    hopper_attention.packs = 0
    out = fn()
    torch.cuda.synchronize()
    launches = {n: c.launches for n, c in counters.items()}
    print(f"[{tag}] launches in one forward: {launches}; pack passes "
          f"{hopper_attention.packs}")
    want = {n: want.get(n, 0) for n in counters}
    require(launches == want, f"[{tag}] launch counts {launches} != {want}")
    if want_packs is not None:
        require(hopper_attention.packs == want_packs,
                f"[{tag}] {hopper_attention.packs} pack passes != "
                f"{want_packs}")
    return launches, out


def phase_silk_forwards(auto_ms: float):
    """(a) The EI_SiLK_LG forward at full width (vgg_np at cell 1 with
    128-d descriptors, the frozen SiLK, LightGlue through its 128 -> 256
    input projection, bf16, B=8, 260x346, K=1024): launches A 18, B 9,
    C 2, 18 pack passes; shapes and finite outputs; latency and pairs/s
    beside phase 3's "auto" forward (`auto_ms`), peak memory. (b)
    EI_SiLK_MNN and SiLKMatcher (SiLK on a frame and the frame shifted by
    2 px): C 2 each, no attention kernel, pairs/s. Returns (EI_SiLK_LG's
    launches, {tag: ms per forward back to back}, its peak GB)."""
    from ei_nexus_tpu_torch.flagship import build_silk
    from ei_nexus_tpu_torch.train.steps import batch_representation

    ev, image = flagship_inputs()
    B = image.shape[0]
    rates, out_launches, peak_gb = {}, None, None
    for name, want in (("EI_SiLK_LG", {"self_attention_rot": 18,
                                       "cross_attention_bidir": 9,
                                       "nms_rounds": 2}),
                       ("EI_SiLK_MNN", {"nms_rounds": 2}),
                       ("SiLKMatcher", {"nms_rounds": 2})):
        model, (H, W, bins) = build_silk(
            name, generator=torch.Generator().manual_seed(0))
        if name == "SiLKMatcher":
            image1 = torch.roll(image, 2, dims=2)

            def forward():
                return model(image, image1)
        else:
            def forward():
                rep, mask = batch_representation(ev, "VoxelGrid", bins, H, W)
                return model(rep, image, mask)
        with torch.inference_mode():
            launches, (f0, f1, m) = _read_launches(
                forward, name, want, 18 if name == "EI_SiLK_LG" else 0)
            L = model.config.matcher.max_points_num
            sides = ((model.image_extractor,) * 2 if name == "SiLKMatcher"
                     else (model.event_extractor, model.image_extractor))
            tops = [ex.config.detection_top_k for ex in sides]
            for f, K in zip((f0, f1), tops):
                require(f["sparse_positions"].shape == (B, K, 3)
                        and f["sparse_descriptors"].shape == (B, K, 128),
                        f"[{name}] keypoint or descriptor shape")
                require(torch.isfinite(f["sparse_positions"]).all()
                        and torch.isfinite(f["sparse_descriptors"]).all(),
                        f"[{name}] non-finite keypoints or descriptors")
            require(m["matches0"].shape == (B, L)
                    and torch.isfinite(m["matching_scores0"]).all(),
                    f"[{name}] match shapes or scores")
            n_valid = [int(f["sparse_valid"].sum()) for f in (f0, f1)]
            n_match = int((m["matches0"] > -1).sum())
            slots = [B * K for K in tops]
            print(f"[{name}] valid keypoints {n_valid} of {slots} per "
                  f"side, {n_match} matches in {B * L} slots")
            require(n_match >= 1, f"[{name}] no valid match")
            torch.cuda.reset_peak_memory_stats()
            per_fwd, median, host_ms = time_calls(forward)
        peak = torch.cuda.max_memory_allocated() / 1e9
        rates[name] = per_fwd
        print(f"[{name}] forward B={B}: latency median {median:.3f} ms; back "
              f"to back {per_fwd:.3f} ms per forward (CUDA events; host "
              f"clock {host_ms:.3f} ms), {B / per_fwd * 1e3:.2f} pairs/s "
              f"({auto_ms / per_fwd:.3f}x the flagship's \"auto\" forward "
              f"in this run); peak memory {peak:.2f} GB")
        if name == "EI_SiLK_LG":
            out_launches, peak_gb = launches, peak
        del model, f0, f1, m
        torch.cuda.empty_cache()
    return out_launches, rates, peak_gb


def phase_nms_cell1(gen) -> dict:
    """(c) Kernel C at the cell-1 score maps, (8, 260, 346) (padding 1)
    and (8, 242, 328) (padding 0): its plan, bit-exact against the plain
    version in float32 and bfloat16, its device time. Returns the keys it
    adds to C's row of the kernels' JSON line."""
    from ei_nexus_tpu_torch.ops import nms_kernel as nk
    dev, plans = {}, {}
    for shape in NMS_CELL1_SHAPES:
        score = torch.rand(*shape, generator=gen, device="cuda")
        score = torch.where(score > 0.3, score, torch.zeros_like(score))
        for dtype in (torch.float32, torch.bfloat16):
            x = score.to(dtype)
            plan = nk.nms_plan(*shape, NMS_RADIUS, NMS_ROUNDS,
                               x.element_size())
            got = nk.nms_rounds(x, NMS_RADIUS, NMS_ROUNDS)
            want = nk.nms_rounds_plain(x, NMS_RADIUS, NMS_ROUNDS)
            torch.cuda.synchronize()
            require(torch.equal(got, want),
                    f"NMS kernel is not bit-exact at {shape} in {dtype}: "
                    f"{int((got != want).sum())} pixels differ")
            text = (f"clusters of {plan.cluster} blocks, {plan.rows} rows "
                    f"of {plan.width} a block, {len(plan.row_strips)} x "
                    f"{len(plan.col_strips)} tiles, {plan.smem_bytes} bytes "
                    f"of shared memory a block")
            plans[f"{shape} {str(dtype)[6:]}"] = text
            print(f"[nms cell 1] {shape} {dtype}: bit-exact; plan {text}")
        dev[str(shape)] = _sum_ms(device_ms(lambda: nk.nms_rounds(
            score, NMS_RADIUS, NMS_ROUNDS)))
        print(f"[nms cell 1] {shape} float32: device {dev[str(shape)]:.4f} "
              f"ms a call; bound {nms_bound_ms(score)[0]:.4f} ms")
    return {"device_ms_cell1": dev, "plan_cell1": plans}


def phase_silk_cpu_vs_gpu():
    """(d) Tiny float32 SiLK-family models on the CPU and on the card
    (kernel C there, the same fixed 4 NMS rounds on the CPU), same weights
    and inputs: EI_SiLK_LG and EI_SiLK_MNN at padding 1, and EI_SiLK_LG
    with vgg_np and SiLK both at padding 0 (VALID, no event mask):
    keypoints, validity and matches equal, score maps and descriptors
    within phase 5's 1e-3."""
    from ei_nexus_tpu_torch.data.synth import bursty_event_batch
    from ei_nexus_tpu_torch.flagship import build_silk
    from ei_nexus_tpu_torch.train.steps import batch_representation

    worst = 0.0
    for i, (name, padding) in enumerate((("EI_SiLK_LG", 1),
                                         ("EI_SiLK_MNN", 1),
                                         ("EI_SiLK_LG", 0))):
        cpu_model, (H, W, bins) = build_silk(
            name, tiny=True, dtype="float32", device="cpu",
            generator=torch.Generator().manual_seed(10 + i), padding=padding)
        for ex in (cpu_model.event_extractor, cpu_model.image_extractor):
            ex.config = dataclasses.replace(ex.config, nms_impl="pallas")
        gpu_model = copy.deepcopy(cpu_model).cuda()
        rng = np.random.default_rng(10 + i)
        ev = bursty_event_batch(rng, 4, 3000, 4096, H, W)
        image = torch.as_tensor(rng.uniform(0, 255, (4, H, W, 1)).astype(
            np.float32))
        out = {}
        with torch.inference_mode():
            for dev, model in (("cpu", cpu_model), ("cuda", gpu_model)):
                rep, mask = batch_representation(ev, "VoxelGrid", bins, H,
                                                 W, device=dev)
                out[dev] = model(rep, image.to(dev),
                                 mask if padding else None)
        (e_c, i_c, m_c), (e_g, i_g, m_g) = out["cpu"], out["cuda"]
        errs = []
        for a, b in ((e_c, e_g), (i_c, i_g)):
            require(torch.equal(a["sparse_positions"][..., :2],
                                b["sparse_positions"][..., :2].cpu()),
                    f"[{name} padding {padding}] keypoints differ")
            require(torch.equal(a["sparse_valid"], b["sparse_valid"].cpu()),
                    f"[{name} padding {padding}] validity differs")
            errs += [max_err(a[k], b[k].cpu()) for k in
                     ("score", "sparse_descriptors")]
        for k in ("matches0", "matches1"):
            require(torch.equal(m_c[k], m_g[k].cpu()),
                    f"[{name} padding {padding}] {k} differ")
        n_match = int((m_c["matches0"] > -1).sum())
        print(f"[cpu-vs-gpu] tiny {name} padding {padding}: keypoints, "
              f"validity and {n_match} matches equal; score and descriptor "
              f"max|err| {max(errs):.2e}")
        require(max(errs) <= 1e-3, f"[{name}] maps differ: {max(errs)}")
        worst = max(worst, max(errs))
    return worst


def phase_silk_stage2():
    """(e) The EIM_stage2_SiLK_LG step at full width through phase 4's
    runner: D 36, F 36, C 2, 18 pack passes; frozen tensors bit-unchanged,
    the loss lower after 10 steps on one batch and fill, steps/s over 24
    steps, peak memory."""
    from ei_nexus_tpu_torch.flagship import build_silk
    model, shape = build_silk("EIM_stage2_SiLK_LG", training_heads=True,
                              generator=torch.Generator().manual_seed(0))
    return phase_stage2("silk-stage2", (model, shape))


def phase_representations():
    """(g) Every representation on the card against the CPU at the
    flagship's input (B=8 bursty streams of 131,072 slots, 16 bins,
    260x346; the DistanceMap's CPU side on the first stream): bit-equal
    for TimeSurface, EventStack, AccumulationImage and DistanceMap, the
    VoxelGrid as phase 5 holds it; the card's ms for each."""
    from ei_nexus_tpu_torch.train.steps import batch_representation

    from ei_nexus_tpu_torch.flagship import flagship_config
    ev, _ = flagship_inputs()
    _, (H, W, bins) = flagship_config()
    ev_cpu = {k: v.cpu() for k, v in ev.items()}
    times = {}
    for kind in ("VoxelGrid", "TimeSurface", "EventStack", "DistanceMap",
                 "AccumulationImage"):
        got, mask = batch_representation(ev, kind, bins, H, W)
        n = 1 if kind == "DistanceMap" else got.shape[0]
        want, want_mask = batch_representation(
            {k: v[:n] for k, v in ev_cpu.items()}, kind, bins, H, W,
            device="cpu")
        got, mask = got[:n].cpu(), mask[:n].cpu()
        require(torch.equal(mask, want_mask), f"[{kind}] masks differ")
        if kind == "VoxelGrid":
            # the card's atomic float sums run in another order: held
            # relative to the grid's largest value (hot pixels reach tens)
            flips = int(((got == 0) != (want == 0)).sum())
            err, top = max_err(got, want), float(want.abs().max())
            require(err <= 1e-5 * max(1.0, top)
                    and flips <= 1e-3 * got.numel(),
                    f"[{kind}] max|err| {err} (max|v| {top}), {flips} zero "
                    f"flips")
            note = (f"max|err| {err:.2e} of max|v| {top:.2f}, {flips} zero "
                    f"flips")
        else:
            require(torch.equal(got, want), f"[{kind}] differs from the CPU")
            note = "bit-equal"
        times[kind] = cuda_ms(lambda: batch_representation(
            ev, kind, bins, H, W), iters=5, warmup=1)
        print(f"[representations] {kind}: card vs CPU on {n} of 8 streams "
              f"{note}; card {times[kind]:.3f} ms a batch of 8 (with the "
              f"accumulation mask)")
    return times


def _steady_rate(log: str) -> float:
    m = re.search(r"steady rate: .* ([0-9.]+) steps/s", log)
    require(m is not None, "no steady rate in the entry's log")
    return float(m.group(1))


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
            if "warning" in line:
                print(f"[setup] {name}: {line.strip()}")
    smi = nvidia_smi_line()
    print(f"[setup] {torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")

    walls = {}

    def timed(name, fn, *args, **kw):
        t = time.perf_counter()
        out = fn(*args, **kw)
        walls[name] = time.perf_counter() - t
        print(f"[wall] {name}: {walls[name]:.1f} s")
        return out

    rows = timed("kernels", phase_kernels, logs)
    launches, fwd_ms, B, _ = timed(
        "forward (auto)", phase_forward, "main",
        {"self_attention_rot": 18, "cross_attention_bidir": 9,
         "nms_rounds": 2}, 18)
    flash_launches, flash_ms, _, flash_fwd = timed(
        "forward (flash)", phase_forward, "flash",
        {"flash_attention": 36, "nms_rounds": 2}, 18, attention_impl="flash")
    serve_ms, pose_ms, syncs = timed("serving with pose", phase_serving_pose,
                                     flash_fwd, B)
    del flash_fwd
    qblock_launches, qblock_ms, _, _ = timed(
        "forward (q-blocked)", phase_forward, "qblock",
        {"qblock_attention": 36, "nms_rounds": 2}, 18, block_q=64)
    timed("pose check", phase_pose_check)
    train_launches, step_ms, _ = timed("stage-2 step", phase_stage2)
    path_of = {"attention_fwd": train_launches, "attention_bwd":
               train_launches, "qblock_attention": qblock_launches,
               "flash_attention": flash_launches}
    for r in rows:
        r["launches"] = path_of.get(r["name"], launches)[r["name"]]
    loader_rate, host_rate, host_share, buckets, stages = timed(
        "loader-fed forward (auto)", phase_loader_forward)
    mnn_ms, _ = timed("MNN forward", phase_mnn_forward)
    timed("cpu vs card, forward", phase_cpu_vs_gpu)
    timed("cpu vs card, stage-2 step", phase_cpu_vs_gpu_train)
    s1_launches, s1_ms, s1_spread, s1_peak = timed("stage-1 step",
                                                   phase_stage1)
    for r in rows:
        r["launches_stage1_step"] = s1_launches[r["name"]]
    timed("cpu vs card, stage-1 step", phase_stage1_cpu_vs_gpu)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ec_")
    try:
        data = os.path.join(tmp, "mini_ec")
        render_s = timed("mini-EC render", render_mini_ec, data)
        entry_rate, entry_walls = timed("stage-1 entry point",
                                        phase_stage1_entry, data, tmp)
        # phase 10: the SiLK family
        silk_launches, silk_ms, silk_peak = timed(
            "SiLK forwards", phase_silk_forwards, fwd_ms)
        c_row = next(r for r in rows if r["name"] == "nms_rounds")
        c_row.update(timed("kernel C at the cell-1 shapes", phase_nms_cell1,
                           torch.Generator(device="cuda").manual_seed(3)))
        timed("cpu vs card, SiLK forwards", phase_silk_cpu_vs_gpu)
        silk_s2_launches, silk_step_ms, silk_s2_peak = timed(
            "SiLK stage-2 step", phase_silk_stage2)
        silk_entry_rate, silk_entry_walls = timed(
            "SiLK stage-1 entry point", phase_stage1_entry, data, tmp,
            "silk-entry", SILK_ENTRY_CONFIG, False)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rep_ms = timed("representations", phase_representations)
    for r in rows:
        r["launches_silk_lg_forward"] = silk_launches[r["name"]]
        r["launches_silk_stage2_step"] = silk_s2_launches[r["name"]]

    print(json.dumps({"kernels": rows}))
    for tag, ms in (("flagship forward", fwd_ms),
                    ("flash forward", flash_ms),
                    ("q-blocked forward (block_q 64)", qblock_ms),
                    ("flash forward + pose", serve_ms)):
        print(f"{tag}: {B / ms * 1e3:.2f} pairs/s ({ms:.3f} ms per batch of "
              f"{B}, back to back) on {smi}")
    print(f"loader-fed forward (auto): {loader_rate:.2f} pairs/s, host only "
          f"{host_rate:.2f} pairs/s, host share {host_share:.1f}%, buckets "
          f"{buckets}, C++ encoder; one batch {json.dumps(stages)}; on "
          f"{smi}")
    print(f"stage-1 (MNN) forward: {B / mnn_ms * 1e3:.2f} pairs/s "
          f"({mnn_ms:.3f} ms per batch of {B}, back to back) on {smi}")
    print(f"pose tail: {pose_ms:.3f} ms per batch of {B} "
          f"({100 * pose_ms / serve_ms:.1f}% of the served batch), {syncs} "
          f"host syncs a call, on {smi}")
    print(f"stage-2 training step: {1e3 / step_ms:.3f} steps/s "
          f"({step_ms:.3f} ms per step of {B} pairs, back to back) on {smi}")
    print(f"stage-1 training step: {1e3 / s1_ms:.3f} steps/s ({s1_ms:.3f} "
          f"ms per step of {B} pairs, back to back; single steps min "
          f"{s1_spread[0]:.3f}, median {s1_spread[1]:.3f}, max "
          f"{s1_spread[2]:.3f} ms; peak {s1_peak:.2f} GB) against the "
          f"stage-2 step's {1e3 / step_ms:.3f} steps/s in this run "
          f"({step_ms / s1_ms:.2f}x), on {smi}")
    print(f"stage-1 entry point (EC config, 160x160 crops, B={B}, from a "
          f"mini-EC rendered in {render_s:.1f} s): steady "
          f"{entry_rate:.3f} steps/s (steps 3-4); process wall "
          f"{entry_walls[0]:.1f} s for 4 steps, {entry_walls[1]:.1f} s "
          f"resumed for 2, on {smi}")
    for name, ms in silk_ms.items():
        print(f"{name} forward: {B / ms * 1e3:.2f} pairs/s ({ms:.3f} ms per "
              f"batch of {B}, back to back; {fwd_ms / ms:.3f}x the flagship's "
              f"\"auto\" forward in this run)"
              + (f", peak {silk_peak:.2f} GB" if name == "EI_SiLK_LG" else "")
              + f", on {smi}")
    print(f"SiLK stage-2 training step (EIM_stage2_SiLK_LG): "
          f"{1e3 / silk_step_ms:.3f} steps/s ({silk_step_ms:.3f} ms per step "
          f"of {B} pairs, back to back; peak {silk_s2_peak:.2f} GB) against "
          f"the flagship's {1e3 / step_ms:.3f} steps/s in this run, on {smi}")
    print(f"SiLK stage-1 entry point (configs/train_EIM_stage1_EC_SiLK_MNN"
          f".yaml, 160x160 crops, B={B}): steady {silk_entry_rate:.3f} "
          f"steps/s (steps 3-4); process wall {silk_entry_walls[0]:.1f} s "
          f"for 4 steps, on {smi}")
    print("representations on the card, ms a batch of 8 (131,072 slots, 16 "
          "bins, 260x346, with the accumulation mask): "
          + json.dumps({k: round(v, 4) for k, v in rep_ms.items()})
          + f", on {smi}")
    print(f"wall seconds by phase: {json.dumps(walls)}")
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
