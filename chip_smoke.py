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
    but for the voxel grid (held as phase 5 holds it), the card's ms;
11. homography-supervised stage 2 and evaluation: (a) the homography
    step at full width through phase 4's runner (the frame warped by a
    random corner jitter, GT from the known H; D 36, F 36, C 2, 18 pack
    passes; GT matches found; frozen tensors bit-unchanged; the loss
    lower after 10 steps on the same batch, jitter and fill; steps/s
    beside phase 4's); (b) the small float32 model's homography step on
    the CPU and the card, the same weights, batch, jitter and fill: H,
    image1, loss, grad_norm and the updated parameters within stated
    bounds; (c) the five EC validation sequences rendered into phase 9's
    mini-EC, then `python -m ei_nexus_tpu_torch.train_matcher --config
    configs/train_EIM_stage2.yaml --stage1-ckpt <phase 9's final>
    --max-steps 4 dataset=ec` (the homography route, B=8, 180x240):
    exit 0, finite losses, a `final` checkpoint, a resume to step 6, the
    steady steps/s; (d) `python -m
    ei_nexus_tpu_torch.test_events_image_different_time dataset=test_ec
    --ckpt <(c)'s final> --max-batches 16` under --backend opencv and
    torch and `python -m ei_nexus_tpu_torch.val_extractor` on phase 9's
    final: exit 0, finite metrics; in this process the eval forward's
    launches around one batch (A, B, C as the shape guard predicts), and
    `rpe_eval`'s pairs/s under each backend with the share of the loop in
    cv2's pose estimation.

12. reference checkpoints and adaptive LightGlue: (a) synthetic `.pth`
    files in the reference's layout (`models/port_torch.py:
    to_reference_layout` of seeded weights: the flagship EIM of
    configs/train_EIM_stage2.yaml and EI_SiLK_LG) read back strictly on
    the card, every tensor bit-equal; `python -m
    ei_nexus_tpu_torch.test_events_image_different_time dataset=test_ec
    --ckpt <.pth> --max-batches 16` over phase 11's mini-EC (exit 0,
    finite AUCs) and, in this process, the .pth eval forward's launches
    (A 18, B 9, C 2); the stage-1 entry with `superpoint_weights=<.pth>`
    for 2 steps (its image extractor equals the file); (b) adaptive
    LightGlue at full width (the flagship, bf16, B=8, depth_confidence
    0.95 and width_confidence 0.99, or width alone for the pruning
    regimes) with the decision heads' biases steered into four regimes
    (never exit: A 18, B 9, matches equal to the plain "auto" forward's on
    one voxel grid; exit after layer 0: A 2, B 1; prune everything: no
    match; prune about half, layer 0's matchability reading descriptor
    channel 0 against its median), each under "auto" (A, B), "flash" (G)
    and block_q=64 (E): launches, the stop-decision host reads
    (`LightGlue.host_syncs`) and every sync PyTorch reports, exit layer,
    surviving share, latency and pairs/s beside phase 3's "auto" forward;
    A, B, E and G against their plain versions at the pruned masks with
    the last batch row pruned whole; a tiny float32 adaptive LightGlue on
    the CPU and the card (exit layers, surviving masks, matches equal);
13. the SLAM back end: (a) `parallel/ba.py:ba_solve` at
    tools/bench_ba.py's defaults (512 keyframes, 65,536 landmarks, 10
    observations each, 12 LM iterations of 20 CG steps, Huber 4 px, z_min
    0.01; its synthetic problem, `ba_problem`): the cost falls; ms per LM
    iteration (CUDA events, the slope between 3 and 12 iterations), host
    syncs in a solve, peak memory; (b) a small exact problem on the CPU
    and the card, plain and robust: costs, poses and points within stated
    bounds; (c) `pose_graph_solve` on an 8-pose ring with a loop closure:
    residuals below 5%; (d) `parallel/slam.py:refine_map` on a synthetic
    drifted trajectory of 40 keyframes with 512 keypoints each: the cost
    and the ATE (Umeyama) fall; (e) the front end's wiring: the stage-1
    MNN model (C 2) on 8 frames, its matcher's matches0 between
    consecutive frames into `chain_tracks` -> `build_ba_problem` ->
    `ba_solve`: finite costs.

14. the multi-process slice: (a) `python -m torch.distributed.run
    --standalone --nproc_per_node <cards> -m
    ei_nexus_tpu_torch.train_matcher` (NCCL, a card a rank: world size 1
    on one card) over phase 11's mini-EC for 4 steps: exit 0, every rank
    printing its NCCL place, rank 0's run directory alone with `final` at
    step 4; (b) 2 gloo ranks on the one card (CUDA tensors staged through
    the host; `parallel/dryrun.py:launch`, spawned after the kernels are
    built) against one process, each at full width (`dp_cases`): the
    stage-2 step over (2, 1), global batch 8 (per rank D 36, F 36, C 2,
    no other kernel, each then held against its plain version on the
    tensors the rank's step hands it; loss, grad_norm, the gradient leaf
    by leaf, matcher parameters); the stage-1 step (global BatchNorm
    statistics; the ranks' event masks unequal: loss, running statistics
    and gradient); the flagship's LightGlue forward (bf16 and float32)
    and the stage-2 step with the heads split over (1, 2) (C 2, no
    attention kernel); BA at tools/bench_ba.py's size with the
    observations split over the 2 ranks (costs within 1e-4 of the
    initial cost); steps/s at
    world size 1 and 2 and the collectives' share of the step, which are
    not scaling figures (two ranks share one card's SMs).

15. the last slice's tools and functions: (a) `slam_mvsec.slam_chain` at
    full width (260x346, 16 bins, VGG 128/256/256, top-k 512, 40
    keyframes at stride 2, 12 LM iterations) with phase 9's stage-1
    checkpoint on indoor_flying1 rendered in memory by
    `data/mini_mvsec.py` and read through the MVSEC reader's windows (the
    card's machine has no h5py): C once a keyframe and no other kernel, C
    bit-exact on the chain's first map, the robust cost and the
    reprojection median lower after BA, the matches measured against the
    rendered truth, the ATE before and after; then the chain on exact
    tracks (`ExactFrontEnd`): the ATE lower after BA, and
    `--check-sharded`'s solve of that problem over 2 gloo ranks on the
    card, its final cost within 1.5e-3 of one process's; (b) `eval_adaptive`'s `main`
    over phase 11's mini-EC with phase 11's stage-2 checkpoint (16 pairs
    at B=1, base then adaptive, then B=8 timed): the exit histogram, both
    protocols' metrics, ms a batch of 8 both ways; launches a forward
    (base A 18, B 9, C 2; adaptive as its exit layer says), A, B and C
    against their plain versions on the adaptive forward's tensors, and
    with depth and width -1 the forward equal to the base one bit for
    bit; (c) the new geometry and detector functions on the card against
    the CPU.

Prints each phase's wall seconds, the kernels' JSON line (launches: A, B,
C from the "auto" forward; D, F from the stage-2 step; E from the
q-blocked forward; G from the flash forward; each row's
launches_stage1_step from the stage-1 step, launches_silk_lg_forward and
launches_silk_stage2_step from phase 10, launches_homography_step and
launches_eval_forward from phase 11, launches_pth_eval_forward and
launches_adaptive_forward by setting/regime from phase 12,
launches_dp_stage2_step_per_rank from phase 14b, and for D, F and C
max_abs_err_dp_rank on a rank's own tensors there;
launches_slam_mvsec_front_end and launches_eval_adaptive_forward (base,
adaptive) from phase 15, and for A, B and C max_abs_err_eval_adaptive on
the adaptive forward's tensors; C's row also
its device ms and
plans at the cell-1 shapes), the card's `nvidia-smi` line, the forward,
serving, loader-fed, MNN, SiLK, step, entry and evaluation rates, the
SLAM and adaptive-evaluation lines of phase 15, and as its last line
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
# D and F against their plain versions: x max(1, max|ref|)
ATTN_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
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
    for dtype, tol in ATTN_TOL.items():
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
    from ei_nexus_tpu_torch.parallel.dryrun import kernel_counters
    return kernel_counters()


def to_cuda(batch):
    """A stage-2 batch of numpy arrays -> the same structure on the card."""
    data0, data1, T01, T10 = batch
    dev = {k: torch.as_tensor(v).cuda() for k, v in data0.items()}
    return (dev, {k: torch.as_tensor(v).cuda() for k, v in data1.items()},
            torch.as_tensor(T01).cuda(), torch.as_tensor(T10).cuda())


def phase_stage2(tag: str = "stage2", built=None, homography=False):
    """The stage-2 step at full width, B=8: the flagship's
    (`build_stage2_flagship`), or `built` = (model on the card with
    LightGlue's training heads, (H, W, bins)); the pose + depth step, or
    with `homography` the homography-supervised one (the frame warped by
    a random corner jitter, GT from the known H; the generator reseeded
    before each step gives the same jitter and fill, and it must find GT
    matches). Returns (launches, ms per step back to back, peak GB)."""
    from ei_nexus_tpu_torch.data.synth import homography_batch, stage2_batch
    from ei_nexus_tpu_torch.flagship import (build_stage2_flagship,
                                             stage2_train_state)
    from ei_nexus_tpu_torch.ops.attention_kernels import hopper_attention
    from ei_nexus_tpu_torch.train.steps import (
        make_stage2_homography_train_step, make_stage2_train_step)

    B, max_events = 8, 1 << 17
    model, (H, W, bins) = built or build_stage2_flagship(
        dtype="bfloat16", generator=torch.Generator().manual_seed(0))
    # 100 steps an epoch: the cosine schedule stays near its base lr here
    state = stage2_train_state(model, steps_per_epoch=100)
    rng = np.random.default_rng(0)
    if homography:
        batch = ({k: torch.as_tensor(v).cuda() for k, v in homography_batch(
            rng, B, int(max_events * 0.95), max_events, H, W)[0].items()},)
        step = make_stage2_homography_train_step("VoxelGrid", bins, H, W)
    else:
        batch = to_cuda(stage2_batch(rng, B, int(max_events * 0.95),
                                     max_events, H, W))
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
    n_gt = float(info["gt_matches"])
    print(f"[{tag}] step 1: loss {loss1:.6f}, grad_norm {gnorm:.6f}, "
          f"gt_matches {n_gt:.2f}")
    require(n_gt > 0 or not homography, "no GT match from the homography")
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


SMALL = dict(H=64, W=96, bins=4, K=128, B=2)   # the small float32 model


def small_stage2_model(seed: int):
    """The small float32 stage-2 model on the CPU (descriptors 256 in 4
    heads of 64, 2 layers, K=128: on the kernels' shape grid; 4 fixed NMS
    rounds on both devices), weights from `seed`, with its training
    heads."""
    from ei_nexus_tpu_torch.flagship import stage2_config
    from ei_nexus_tpu_torch.models.eim import EIM
    from ei_nexus_tpu_torch.models.layers import init_parameters

    bins, K = SMALL["bins"], SMALL["K"]
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
    model = EIM(cfg, training_heads=True)
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model


def small_fill(rng):
    """One slot fill for both devices: positions uniform over the small
    model's image (zero third column), unit normal descriptors."""
    H, W, K, B = SMALL["H"], SMALL["W"], SMALL["K"], SMALL["B"]
    pos = np.concatenate([rng.uniform(0, 1, (B, K, 2)) * [H, W],
                          np.zeros((B, K, 1))], -1).astype(np.float32)
    desc = rng.normal(size=(B, K, 256))
    desc = (desc / np.linalg.norm(desc, axis=-1, keepdims=True)).astype(
        np.float32)
    return tuple((torch.as_tensor(pos), torch.as_tensor(desc))
                 for _ in range(2))


def compare_steps(tag, step, batch, fill, seed, **kw):
    """One stage-2 `step` of the small model (weights from `seed`) on the
    CPU (plain versions) and on the card (kernels D, F, C), the same
    batch, fill and `kw`: loss (rel 1e-4), grad_norm (rel 1e-3), GT
    matches equal, updated parameters within 4 lr. Returns the errors."""
    from ei_nexus_tpu_torch.flagship import STAGE2_LR, stage2_train_state

    cpu_model = small_stage2_model(seed)
    gpu_model = copy.deepcopy(cpu_model).cuda()
    res = {}
    for name, model in (("cpu", cpu_model), ("cuda", gpu_model)):
        state = stage2_train_state(model)
        dev_fill = tuple((p.to(name), d.to(name)) for p, d in fill)
        info = step(state, batch, fill=dev_fill,
                    **{k: v.to(name) for k, v in kw.items()})
        res[name] = ({k: float(v) for k, v in info.items()},
                     {k: v.cpu() for k, v in model.state_dict().items()})
    (ic, sc), (ig, sg) = res["cpu"], res["cuda"]
    e_loss = abs(ig["loss"] - ic["loss"]) / abs(ic["loss"])
    e_norm = abs(ig["grad_norm"] - ic["grad_norm"]) / ic["grad_norm"]
    e_par = max(max_err(sg[k], sc[k]) for k in sc)
    lr = STAGE2_LR
    print(f"[cpu-vs-gpu] {tag}: loss {ic['loss']:.6f} (cpu) vs "
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


def phase_cpu_vs_gpu_train():
    """One stage-2 step of the small float32 model (`small_stage2_model`)
    on the CPU (plain versions) and on the card (kernels D, F, C), same
    weights, batch and fill."""
    from ei_nexus_tpu_torch.data.synth import stage2_batch
    from ei_nexus_tpu_torch.train.steps import make_stage2_train_step

    H, W, bins, B = SMALL["H"], SMALL["W"], SMALL["bins"], SMALL["B"]
    rng = np.random.default_rng(2)
    batch = stage2_batch(rng, B, 6000, 8192, H, W)
    return compare_steps("stage-2 step",
                         make_stage2_train_step("VoxelGrid", bins, H, W),
                         batch, small_fill(rng), seed=2)


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


def _run_module(module, args, timeout=600):
    """`python -m ei_nexus_tpu_torch.<module> <args>` on the card; returns
    (its stdout, wall seconds). Raises on a non-zero exit."""
    cmd = [sys.executable, "-m", f"ei_nexus_tpu_torch.{module}"] + args
    t = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=timeout)
    wall = time.perf_counter() - t
    if proc.returncode != 0:
        print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
    require(proc.returncode == 0, f"{module} exited {proc.returncode}")
    return proc.stdout, wall


def _entry_run(extra, data, out, config=ENTRY_CONFIG, timeout=600,
               module="train_extractor", overrides=()):
    """A training entry (`python -m ei_nexus_tpu_torch.<module>`, options
    `extra` before the key=value `overrides`) on the card over the
    rendered mini-EC; returns (its run directory, metrics rows, log text,
    wall seconds). Raises on a non-zero exit."""
    _, wall = _run_module(module, ["--config", config] + extra + list(
        overrides) + [f"dataset.data_path={data}", f"logger.output_dir={out}",
                      "logger.status_freq=1"], timeout)
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


def phase_entry(data: str, tmp: str, tag: str = "entry",
                config: str = ENTRY_CONFIG, resume: bool = True,
                module: str = "train_extractor", options=(), overrides=(),
                expect=("training at 160x160",)):
    """A training entry point from disk, over the mini-EC rendered in
    `data`: `python -m ei_nexus_tpu_torch.<module> --config <config>
    <options> --max-steps 4 <overrides>` on the card (the stage-1 entry by
    default: the full-width EC config at its 160x160 crops, B=8, 4 loader
    threads), its runs under `tmp`: exit 0, each of `expect` in its log,
    finite logged values at steps 1-4, a `final` checkpoint at step 4;
    then, with `resume`, `--resume <final> --max-steps 6`: steps 5 and 6.
    Returns the entry's steady steps/s (its own log: steps 3 and 4, timed
    from the drain of step 1 to that of step 4), the runs' process wall
    seconds and the first run's `final` checkpoint."""
    run, rows, log, wall = _entry_run(
        list(options) + ["--max-steps", "4"], data,
        os.path.join(tmp, f"{tag}_runs"), config, module=module,
        overrides=overrides)
    require([r["step"] for r in rows] == [1, 2, 3, 4],
            f"logged steps {[r['step'] for r in rows]}")
    for r in rows:
        require(all(np.isfinite(v) for v in r.values()),
                f"non-finite logged values {r}")
    for line in expect:
        require(line in log, f"[{tag}] no {line!r} in the log")
    final = os.path.join(run, "checkpoints", "final")
    ck = torch.load(os.path.join(final, "state.pt"), map_location="cpu",
                    weights_only=True)
    require(ck["step"] == 4, f"final checkpoint at step {ck['step']}")
    rate = _steady_rate(log)
    print(f"[{tag}] {config}: 4 steps in {wall:.1f} s (process wall): "
          f"losses " + ", ".join(f"{r['loss']:.5f}" for r in rows)
          + f"; steady {rate:.3f} steps/s")
    if not resume:
        return rate, (wall,), final
    run2, rows2, log2, wall2 = _entry_run(
        list(options) + ["--max-steps", "6", "--resume", final], data,
        os.path.join(tmp, f"{tag}_runs2"), config, module=module,
        overrides=overrides)
    require([r["step"] for r in rows2] == [5, 6],
            f"resumed at steps {[r['step'] for r in rows2]}")
    require("resumed from" in log2, "no resume in the log")
    ck2 = torch.load(os.path.join(run2, "checkpoints", "final",
                                  "state.pt"), map_location="cpu",
                     weights_only=True)
    require(ck2["step"] == 6, f"resumed final at step {ck2['step']}")
    print(f"[{tag}] resumed from step 4 to 6 in {wall2:.1f} s (process "
          f"wall): losses " + ", ".join(f"{r['loss']:.5f}" for r in rows2))
    return rate, (wall, wall2), final


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


# ---------------------------------------------------------------------------
# phase 11: homography-supervised stage 2, its entry, and evaluation
# ---------------------------------------------------------------------------

STAGE2_CONFIG = "configs/train_EIM_stage2.yaml"
EVAL_BATCHES = 16


def render_mini_ec_val(root: str) -> float:
    """The five EC validation sequences and their pair files rendered into
    phase 9's mini-EC; returns the seconds it took."""
    from ei_nexus_tpu_torch.data.ec import VAL_SEQUENCES
    from ei_nexus_tpu_torch.data.mini_ec import make_mini_ec

    t = time.perf_counter()
    counts = make_mini_ec(root, ENTRY_FRAMES, sequences=VAL_SEQUENCES)
    render_s = time.perf_counter() - t
    n_pairs = sum(len(np.loadtxt(os.path.join(root, f"new_{q}_val.txt"),
                             ndmin=2)) for q in VAL_SEQUENCES)
    print(f"[eval] rendered the mini-EC's {len(counts)} validation "
          f"sequences ({ENTRY_FRAMES} frames, {n_pairs} pairs) in "
          f"{render_s:.1f} s")
    return render_s


def phase_homography_cpu_vs_gpu():
    """(b) The homography step of the small float32 model on the CPU and
    the card, the same weights, batch, corner jitter and fill: H to 1e-4
    of max|H|; image1 within 1e-5 of max|image| plus what the two devices'
    float32 H^-1 move the sampling points (bilinear sampling moves a value
    by at most max|image| a pixel moved along x and along y); then the
    step as phase 5 holds it (`compare_steps`)."""
    from ei_nexus_tpu_torch.data.synth import homography_batch
    from ei_nexus_tpu_torch.ops import homographic as hg
    from ei_nexus_tpu_torch.train.steps import (
        homography_view, make_stage2_homography_train_step)

    H, W, bins, B = SMALL["H"], SMALL["W"], SMALL["bins"], SMALL["B"]
    rng = np.random.default_rng(4)
    batch = homography_batch(rng, B, 6000, 8192, H, W)
    jitter = torch.as_tensor((rng.uniform(-1, 1, (B, 4, 2)) * [W, H]
                              * 0.125).astype(np.float32))
    fill = small_fill(rng)
    image0 = torch.as_tensor(batch[0]["image"])
    Hc, ic = homography_view(image0, jitter, H, W)
    Hg, ig = homography_view(image0.cuda(), jitter.cuda(), H, W)
    e_h = max_err(Hg.cpu(), Hc) / float(Hc.abs().max())
    grid = hg.create_meshgrid(W, H, normalized=False).reshape(-1, 2)
    moved = max_err(
        hg.transform_points(torch.linalg.inv_ex(Hg)[0], grid.cuda()).cpu(),
        hg.transform_points(torch.linalg.inv_ex(Hc)[0], grid)) * 2
    top = float(image0.abs().max())
    e_img, bound = max_err(ig.cpu(), ic), (1e-5 + moved) * top
    print(f"[cpu-vs-gpu] homography view: H rel {e_h:.2e}; sampling points "
          f"moved <= {moved:.2e} px; image1 max|err| {e_img:.2e} (bound "
          f"{bound:.2e})")
    require(e_h <= 1e-4, f"H differs: rel {e_h:.2e}")
    require(e_img <= bound, f"image1 differs: {e_img:.2e} > {bound:.2e}")
    return compare_steps("homography step",
                         make_stage2_homography_train_step("VoxelGrid", bins,
                                                           H, W),
                         batch, fill, seed=3, jitter=jitter)


def phase_eval_entries(data: str, stage2_final: str, stage1_final: str):
    """(d) The evaluation entry points on the card, over the mini-EC's
    validation pairs: `test_events_image_different_time` (EC's test
    protocol, the stage-2 entry's checkpoint, the first EVAL_BATCHES
    pairs) under --backend opencv and --backend torch, each exit 0 with
    finite RPE AUCs; `val_extractor` on the stage-1 entry's checkpoint:
    finite R@1 (and MMA@3 where it matched). Returns the process walls."""
    walls = {}
    for backend in ("opencv", "torch"):
        out, walls[backend] = _run_module(
            "test_events_image_different_time",
            ["--config", STAGE2_CONFIG, "--ckpt", stage2_final, "--backend",
             backend, "--max-batches", str(EVAL_BATCHES), "dataset=test_ec",
             f"dataset.data_path={data}"])
        m = json.loads(out)
        aucs = {t: m[f"RPE@{t}_auc"] for t in (5, 10, 20)}
        print(f"[eval] test_events_image_different_time --backend {backend}: "
              f"{m['n_pairs']} pairs, AUC@5/10/20 {aucs[5]:.4f} / "
              f"{aucs[10]:.4f} / {aucs[20]:.4f}, RPE_pose_errs "
              f"{m['RPE_pose_errs']}, in {walls[backend]:.1f} s (process "
              f"wall)")
        require(m["n_pairs"] == EVAL_BATCHES, f"{m['n_pairs']} pairs")
        require(all(np.isfinite(v) for v in aucs.values()),
                f"non-finite RPE AUC {aucs}")
    out, walls["val_extractor"] = _run_module(
        "val_extractor", ["--config", ENTRY_CONFIG, "--ckpt", stage1_final,
                          "--max-batches", str(EVAL_BATCHES),
                          f"dataset.data_path={data}"])
    m = json.loads(out)
    print(f"[eval] val_extractor: R@1 {m['R@1']:.4f}, R@3 {m['R@3']:.4f}, "
          f"MMA@3 {m.get('MMA@3', 'no match')}, MR {m['MR']:.4f}, in "
          f"{walls['val_extractor']:.1f} s (process wall)")
    require(np.isfinite(m["R@1"]) and np.isfinite(m.get("MMA@3", 0.0)),
            f"non-finite val_extractor metrics {m}")
    return walls


def phase_eval_loop(data: str, stage2_final: str):
    """(d) In this process, the stage-2 model of configs/train_EIM_stage2
    .yaml with the stage-2 entry's checkpoint over EC's test protocol
    (B=1, 180x240, 1024 matcher slots): the eval forward's launches read
    around one batch, held to what the shape guard predicts (A for each
    layer's two self-attentions and B once a layer where
    `_pallas_supported` holds at 1024 tokens, C once an extractor); then
    `rpe_eval` over the first EVAL_BATCHES pairs from the loader, after a
    warm pass, under each backend: pairs/s, and for OpenCV the share of
    the loop's wall spent in cv2's pose estimation on the host. Returns
    (launches, {backend: pairs/s}, cv2 share)."""
    from ei_nexus_tpu_torch.data import DataLoader
    from ei_nexus_tpu_torch.metrics import matching
    from ei_nexus_tpu_torch.models.lightglue import _pallas_supported
    from ei_nexus_tpu_torch.train.evaluate import (build_eval_model,
                                                   rpe_eval, val_dataset)
    from ei_nexus_tpu_torch.train.steps import make_eval_step
    from ei_nexus_tpu_torch.utils import load_config

    cfg = load_config(STAGE2_CONFIG, ["dataset=test_ec",
                                      f"dataset.data_path={data}"])
    ds = cfg.dataset.to_dict()
    (H, W), bins, rep = ds["resolution"], ds["channel"], \
        ds["representation_type"]
    model = build_eval_model(cfg.model.to_dict(), stage2_final, "cuda")
    val_ds = val_dataset(ds)

    def loader():
        return DataLoader(val_ds, batch_size=1, shuffle=False,
                          drop_last=False)

    lg = model.config.matcher.lightglue
    n, d = model.config.matcher.max_points_num, lg.descriptor_dim // \
        lg.num_heads
    want = {"self_attention_rot": 2 * lg.n_layers * _pallas_supported(n, d),
            "cross_attention_bidir": lg.n_layers * _pallas_supported(n, d, n),
            "nms_rounds": 2}
    print(f"[eval] the shape guard at {n} tokens, heads of {d}: self "
          f"{_pallas_supported(n, d)}, cross {_pallas_supported(n, d, n)}")
    step = make_eval_step(rep, bins, H, W)
    batch = next(iter(loader()))
    launches, (_, _, matches) = _read_launches(lambda: step(model, batch),
                                               "eval", want)
    require(any(launches.values()), "the eval forward launched no kernel")
    print(f"[eval] one batch: {int((matches['matches0'] > -1).sum())} "
          f"matches of {n} slots")

    cv2_s = [0.0]
    timed_pose = matching.RelativePoseEstimation.estimate_pose

    def estimate_pose(self, *args, **kw):
        t = time.perf_counter()
        try:
            return timed_pose(self, *args, **kw)
        finally:
            cv2_s[0] += time.perf_counter() - t

    rates, share = {}, None
    matching.RelativePoseEstimation.estimate_pose = estimate_pose
    try:
        for backend in ("opencv", "torch"):
            rpe_eval(model, loader(), rep, bins, H, W, backend=backend,
                     max_batches=2)                  # warm
            cv2_s[0] = 0.0
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = rpe_eval(model, loader(), rep, bins, H, W,
                           backend=backend, max_batches=EVAL_BATCHES)
            wall = time.perf_counter() - t
            rates[backend] = out["n_pairs"] / wall
            if backend == "opencv":
                share = cv2_s[0] / wall
            print(f"[eval] rpe_eval --backend {backend}: {out['n_pairs']} "
                  f"pairs in {wall:.3f} s, {rates[backend]:.2f} pairs/s"
                  + (f"; cv2 pose estimation {cv2_s[0]:.3f} s, "
                     f"{100 * share:.1f}% of the loop"
                     if backend == "opencv" else ""))
    finally:
        matching.RelativePoseEstimation.estimate_pose = timed_pose
    return launches, rates, share


# ---------------------------------------------------------------------------
# phase 12: reference .pth checkpoints, and adaptive LightGlue
# ---------------------------------------------------------------------------

PTH_SEED = 12


def phase_pth(data: str, tmp: str):
    """(12a) Reference `.pth` checkpoints (synthetic: a seeded model's
    weights written in the reference's layout by `to_reference_layout`,
    none being in the repository): the flagship EIM of
    configs/train_EIM_stage2.yaml (SuperPoint + LightGlue, its eval model)
    and EI_SiLK_LG, each saved with `torch.save` into `tmp` and read back
    through `models/port_torch.py` into a model on the card strictly, every
    tensor bit-equal to the source's; then `python -m
    ei_nexus_tpu_torch.test_events_image_different_time dataset=test_ec
    --ckpt <flagship .pth> --max-batches 16` over phase 11's mini-EC: exit
    0, finite AUCs; in this process the .pth eval forward's launches
    around one batch (A 18, B 9, C 2); and the stage-1 entry with
    `superpoint_weights=<a synthetic superpoint_v1.pth>` for 2 steps: the
    image extractor of its checkpoint equals the file. Returns (the eval
    forward's launches, process walls)."""
    from ei_nexus_tpu_torch.data import DataLoader
    from ei_nexus_tpu_torch.flagship import build_silk
    from ei_nexus_tpu_torch.models import build_model
    from ei_nexus_tpu_torch.models.config_adapter import eim_config_from_dict
    from ei_nexus_tpu_torch.models.layers import init_parameters
    from ei_nexus_tpu_torch.models.port_torch import (
        load_eim_torch_checkpoint, load_torch_file, to_reference_layout)
    from ei_nexus_tpu_torch.train.evaluate import (build_eval_model,
                                                   val_dataset)
    from ei_nexus_tpu_torch.train.steps import make_eval_step
    from ei_nexus_tpu_torch.utils import load_config

    cfg = load_config(STAGE2_CONFIG, ["dataset=test_ec",
                                      f"dataset.data_path={data}"])
    model_dict = cfg.model.to_dict()
    flagship = build_eval_model(model_dict, device="cpu", seed=PTH_SEED)
    silk, _ = build_silk("EI_SiLK_LG", device="cpu", training_heads=True,
                         generator=torch.Generator().manual_seed(PTH_SEED))
    paths = {}
    for name, src, image in (("flagship", flagship, "superpointv1"),
                             ("EI_SiLK_LG", silk, "silk")):
        path = os.path.join(tmp, f"{name}_reference.pth")
        ref = to_reference_layout(src.state_dict(), image)
        torch.save(ref, path)
        c = src.config
        sd = load_eim_torch_checkpoint(
            load_torch_file(path), image_extractor_type=image,
            matcher_type=c.matcher.type,
            n_lightglue_layers=c.matcher.lightglue.n_layers,
            use_batchnorm=c.event_extractor.use_batchnorm)
        dst = type(src)(c, training_heads=True).cuda()
        dst.load_state_dict(sd, strict=True)
        want = src.state_dict()
        bad = [k for k, v in dst.state_dict().items()
               if not torch.equal(v.cpu(), want[k])]
        require(not bad, f"[pth] {name}: {len(bad)} tensors differ, "
                         f"{bad[:3]}")
        mb = os.path.getsize(path) / 2 ** 20
        print(f"[pth] {name}: {len(ref)} reference keys ({mb:.1f} MiB) -> "
              f"{len(sd)} tensors, loaded strictly on the card, each "
              f"bit-equal to the source")
        paths[name] = path
        del dst

    walls = {}
    out, walls["eval entry"] = _run_module(
        "test_events_image_different_time",
        ["--config", STAGE2_CONFIG, "--ckpt", paths["flagship"],
         "--max-batches", str(EVAL_BATCHES), "dataset=test_ec",
         f"dataset.data_path={data}"])
    m = json.loads(out)
    aucs = {t: m[f"RPE@{t}_auc"] for t in (5, 10, 20)}
    print(f"[pth] test_events_image_different_time --ckpt <.pth>: "
          f"{m['n_pairs']} pairs, AUC@5/10/20 {aucs[5]:.4f} / {aucs[10]:.4f}"
          f" / {aucs[20]:.4f}, in {walls['eval entry']:.1f} s (process "
          f"wall)")
    require(m["n_pairs"] == EVAL_BATCHES, f"{m['n_pairs']} pairs")
    require(all(np.isfinite(v) for v in aucs.values()),
            f"non-finite RPE AUC {aucs}")

    model = build_eval_model(model_dict, paths["flagship"], "cuda")
    want = flagship.state_dict()
    require(all(torch.equal(v.cpu(), want[k])
                for k, v in model.state_dict().items()),
            "the eval model's weights differ from the .pth's")
    ds = cfg.dataset.to_dict()
    (H, W), bins = ds["resolution"], ds["channel"]
    step = make_eval_step(ds["representation_type"], bins, H, W)
    batch = next(iter(DataLoader(val_dataset(ds), batch_size=1,
                                 shuffle=False, drop_last=False)))
    launches, _ = _read_launches(
        lambda: step(model, batch), "pth-eval",
        {"self_attention_rot": 18, "cross_attention_bidir": 9,
         "nms_rounds": 2})

    # the stage-1 entry with superpoint_weights
    s1 = load_config(ENTRY_CONFIG).model.to_dict()
    sp = build_model(s1.get("name", "EIM"), eim_config_from_dict(s1),
                     device="cpu").image_extractor
    init_parameters(sp, torch.Generator().manual_seed(PTH_SEED))
    sp_sd = {k: v.float().clone() for k, v in sp.state_dict().items()}
    sp_path = os.path.join(tmp, "superpoint_v1.pth")
    torch.save(sp_sd, sp_path)
    run, rows, log, walls["stage-1 entry"] = _entry_run(
        ["--max-steps", "2"], data, os.path.join(tmp, "sp_runs"),
        overrides=[f"superpoint_weights={sp_path}"])
    require([r["step"] for r in rows] == [1, 2],
            f"logged steps {[r['step'] for r in rows]}")
    require("loaded SuperPoint weights" in log, "no SuperPoint load logged")
    ck = torch.load(os.path.join(run, "checkpoints", "final", "state.pt"),
                    map_location="cpu", weights_only=True)["model"]
    bad = [k for k, v in sp_sd.items()
           if not torch.equal(ck[f"image_extractor.{k}"].float(), v)]
    require(not bad, f"[pth] the trained image extractor differs from "
                     f"superpoint_weights: {bad[:3]}")
    print(f"[pth] train_extractor superpoint_weights=<.pth>: 2 steps in "
          f"{walls['stage-1 entry']:.1f} s (process wall), losses "
          + ", ".join(f"{r['loss']:.5f}" for r in rows)
          + f"; its {len(sp_sd)} SuperPoint tensors equal the file's")
    return launches, walls


# the adaptive settings (the reference's defaults) and the regimes the
# decision heads' biases are steered into, as tests/test_lightglue_adaptive
# .py steers them: with depth_confidence on, a token is pruned only once
# confident, and a batch whose tokens are all confident stops, so the
# pruning regimes run width_confidence alone, as those tests do
ADAPTIVE = dict(depth_confidence=0.95, width_confidence=0.99)
WIDTH_ONLY = dict(width_confidence=0.99)
REGIMES = {"never_exit": ADAPTIVE, "exit_after_layer_0": ADAPTIVE,
           "prune_all": WIDTH_ONLY, "prune_half": WIDTH_ONLY}
KEEP_LOGIT = float(np.log(0.01 / 0.99))   # sigmoid > 1 - 0.99


def adaptive_flagship(plain_sd, extra, attention_impl="auto", block_q=0):
    """The flagship (bf16) with adaptive LightGlue (`extra`) on the card:
    `plain_sd`'s weights (phase 3's seed) and the heads the plain model
    lacks (the first eight assignment heads, the token confidences) from
    seed 1."""
    from ei_nexus_tpu_torch.flagship import flagship_config
    from ei_nexus_tpu_torch.models.eim import EIM
    from ei_nexus_tpu_torch.models.layers import init_parameters

    cfg, shape = flagship_config(dtype="bfloat16",
                                 attention_impl=attention_impl,
                                 block_q=block_q)
    lg = dataclasses.replace(cfg.matcher.lightglue, **extra)
    cfg = dataclasses.replace(cfg, matcher=dataclasses.replace(
        cfg.matcher, lightglue=lg))
    model = EIM(cfg)
    init_parameters(model, torch.Generator().manual_seed(1))
    res = model.load_state_dict(plain_sd, strict=False)
    require(not res.unexpected_keys, f"{res.unexpected_keys}")
    return model.cuda().eval(), shape


def _steer(model, regime, median0=None):
    """Set the decision heads' biases (and, for prune_half, layer 0's
    matchability readout) for `regime`, in place."""
    lg = model.matcher.lightglue
    L = lg.config.n_layers
    with torch.no_grad():
        for i in range(L - 1):
            tok = lg.token_confidence[str(i)].bias
            mat = lg.log_assignment[str(i)].matchability
            if regime == "never_exit":
                tok.fill_(-10.0)
            elif regime == "exit_after_layer_0":
                tok.fill_(10.0)
            elif regime == "prune_all":
                mat.bias.fill_(-10.0)
            elif regime == "prune_half":
                mat.bias.fill_(10.0)
                if i == 0 and median0 is not None:
                    # the logit reads descriptor channel 0: about half the
                    # valid tokens lie below the median
                    mat.weight.zero_()
                    mat.weight[0, 0] = 1.0
                    mat.bias.fill_(KEEP_LOGIT - median0)


def _layer0_median(model, forward) -> float:
    """The median over valid tokens of descriptor channel 0 after
    LightGlue's first layer (a hook on it), for prune_half's readout."""
    seen = []
    hook = model.matcher.lightglue.transformers[0].register_forward_hook(
        lambda mod, args, out: seen.append((out, args[4], args[5])))
    try:
        forward()
    finally:
        hook.remove()
    (d0, d1), m0, m1 = seen[0]
    vals = torch.cat([d0[..., 0][m0], d1[..., 0][m1]]).float()
    return float(vals.median())


def phase_adaptive(plain_ms: float):
    """(12b) Adaptive LightGlue at full width (the flagship, bf16, B=8,
    260x346, K=1024, 9 layers of 4x64) in four steered regimes under
    "auto" (A, B), "flash" (G) and `block_q=64` (E): launches, LightGlue's
    host reads of the stop decision and every sync PyTorch reports,
    exit_layer, surviving share, latency and pairs/s beside phase 3's
    "auto" forward (`plain_ms`). never_exit's matches equal the plain
    "auto" forward's on the same weights; prune_all matches nothing. A, B,
    E and G are then held against their plain versions at prune_half's
    surviving masks with the last batch row pruned whole; and a tiny
    float32 adaptive LightGlue (128 tokens, heads of 64: the kernels'
    grid) runs on the CPU and the card: exit layers, surviving masks and
    matches equal. Returns ({setting/regime: launches}, {setting/regime:
    row of numbers})."""
    from ei_nexus_tpu_torch.flagship import build_flagship, flagship_config
    from ei_nexus_tpu_torch.models.lightglue import LightGlue
    from ei_nexus_tpu_torch.train.steps import batch_representation

    plain, (H, W, bins) = build_flagship(
        dtype="bfloat16", generator=torch.Generator().manual_seed(0))
    plain_sd = {k: v.cpu() for k, v in plain.state_dict().items()}
    ev, image = flagship_inputs()
    B = image.shape[0]

    def forward_of(model):
        def forward():
            rep, mask = batch_representation(ev, "VoxelGrid", bins, H, W)
            return model(rep, image, mask)
        return forward

    with torch.inference_mode():
        # one voxel grid for the equality check (the card's scatter adds
        # atomically, in any order)
        rep0, mask0 = batch_representation(ev, "VoxelGrid", bins, H, W)
        plain_m = plain(rep0, image, mask0)[2]
        _, plain_syncs, _ = count_syncs(forward_of(plain))
    del plain
    print(f"[adaptive] the plain \"auto\" forward: {plain_syncs} host syncs "
          f"PyTorch reports")
    n_layers = flagship_config()[0].matcher.lightglue.n_layers
    launches, rows = {}, {}
    half_masks = None
    settings = (("auto", "auto", 0, ("self_attention_rot",
                                     "cross_attention_bidir")),
                ("flash", "flash", 0, ("flash_attention",)),
                ("qblock64", "auto", 64, ("qblock_attention",)))
    for setting, impl, block_q, names in settings:
        models = {}
        for extra in (ADAPTIVE, WIDTH_ONLY):
            models[tuple(extra)] = adaptive_flagship(plain_sd, extra, impl,
                                                     block_q)[0]
        for regime, extra in REGIMES.items():
            model = models[tuple(extra)]
            forward = forward_of(model)
            with torch.inference_mode():
                median0 = None
                if regime == "prune_half":
                    _steer(model, regime)
                    median0 = _layer0_median(model, forward)
                _steer(model, regime, median0)
                exits = {"never_exit": n_layers - 1,
                         "exit_after_layer_0": 0}.get(regime, n_layers - 1)
                # layers run: A twice a layer, B once, G and E 4 a layer
                per_layer = {"self_attention_rot": 2,
                             "cross_attention_bidir": 1,
                             "flash_attention": 4, "qblock_attention": 4}
                want = {n: per_layer[n] * (exits + 1) for n in names}
                want["nms_rounds"] = 2
                tag = f"adaptive {setting}/{regime}"
                got, (f0, f1, m) = _read_launches(forward, tag, want)
                LightGlue.host_syncs = 0
                _, syncs, where = count_syncs(forward)
                lg_syncs = LightGlue.host_syncs
                exit_layer = int(m["exit_layer"])
                valid = int(f0["sparse_valid"].sum() + f1["sparse_valid"].sum())
                alive = int(m["surviving0"].sum() + m["surviving1"].sum())
                n_match = int((m["matches0"] > -1).sum())
                require(exit_layer == exits, f"[{tag}] exit layer "
                                             f"{exit_layer} != {exits}")
                reads = min(exits + 1, n_layers - 1) \
                    if extra is ADAPTIVE else 0
                require(lg_syncs == reads,
                        f"[{tag}] {lg_syncs} stop-decision reads != {reads}")
                require(torch.isfinite(m["matching_scores0"]).all(),
                        f"[{tag}] non-finite scores")
                if regime == "never_exit" and setting == "auto":
                    same = model(rep0, image, mask0)[2]
                    require(torch.equal(same["matches0"],
                                        plain_m["matches0"]),
                            "[adaptive] never_exit's matches differ from "
                            "the plain forward's")
                if regime == "prune_all":
                    require(alive == 0 and n_match == 0,
                            f"[{tag}] {alive} survive, {n_match} match")
                if regime == "prune_half":
                    require(0.3 * valid < alive < 0.7 * valid,
                            f"[{tag}] {alive} of {valid} survive")
                    if setting == "auto":
                        half_masks = (m["surviving0"].clone(),
                                      m["surviving1"].clone())
                per_fwd, median, host_ms = time_calls(forward)
            launches[f"{setting}/{regime}"] = got
            rows[f"{setting}/{regime}"] = {
                "exit_layer": exit_layer, "surviving": alive / valid,
                "matches": n_match, "stop_reads": lg_syncs,
                "syncs": syncs, "latency_ms": median, "ms": per_fwd,
                "pairs_per_s": B / per_fwd * 1e3,
                "vs_plain": plain_ms / per_fwd}
            print(f"[{tag}] exit after layer {exit_layer}, surviving "
                  f"{alive}/{valid} ({100 * alive / valid:.1f}%), "
                  f"{n_match} matches; {lg_syncs} stop-decision reads, "
                  f"{syncs} host syncs in all ({plain_syncs} in the plain "
                  f"forward; at {where}); latency median {median:.3f} ms, "
                  f"back to back {per_fwd:.3f} ms, {B / per_fwd * 1e3:.2f} "
                  f"pairs/s ({plain_ms / per_fwd:.3f}x phase 3's \"auto\" "
                  f"forward)")
        del models
    check_pruned_kernels(half_masks)
    check_adaptive_cpu_vs_gpu()
    return launches, rows


def check_pruned_kernels(masks):
    """A, B, E (block_q 64) and G against their plain versions, bf16 at
    the flagship's attention shapes, with the key masks the prune_half
    run left (the last batch row pruned whole: its keys all masked, which
    the -1e9 key bias, or G's mask value, turns into a uniform average of
    the values on both sides)."""
    from ei_nexus_tpu_torch.ops import attention_kernels as ak
    from ei_nexus_tpu_torch.ops import flash_kernel as fk

    gen = torch.Generator(device="cuda").manual_seed(12)
    x = attention_inputs(torch.bfloat16, gen)
    m0, m1 = (m.clone() for m in masks)
    m0[-1] = False
    m1[-1] = False
    tol = 2e-2

    def check(name, got, want):
        torch.cuda.synchronize()
        got, want = (got if isinstance(got, tuple) else (got,),
                     want if isinstance(want, tuple) else (want,))
        for g, w in zip(got, want):
            require(bool(torch.isfinite(g.float()).all()),
                    f"{name} non-finite at the pruned masks")
            e = max_err(g, w)
            bound = tol * max(1.0, float(w.float().abs().max()))
            require(e <= bound, f"{name} disagrees at the pruned masks: "
                                f"{e:.3e} > {bound:.3e}")
        print(f"[adaptive] {name} at the pruned masks (row {MAIN_B - 1} "
              f"all pruned): max|err| "
              f"{max(max_err(g, w) for g, w in zip(got, want)):.3e}")

    check("self_attention (A)",
          ak.self_attention(x["q"], x["k"], x["v"], m0, rot=x["rot"]),
          ak.self_attention_plain(x["q"], x["k"], x["v"], m0, rot=x["rot"]))
    check("cross_attention_bidir (B)",
          ak.cross_attention_bidir(x["qk0"], x["qk1"], x["v0"], x["v1"], m0,
                                   m1),
          ak.cross_attention_bidir_plain(x["qk0"], x["qk1"], x["v0"],
                                         x["v1"], m0, m1))
    b0 = ak.key_bias(m0, MAIN_B, MAIN_N, "cuda")
    check("qblock_attention (E)",
          ak.qblock_attention(x["q"], x["k"], x["v"], b0, MAIN_D ** -0.5, 64,
                              x["rot"]),
          ak.qblock_attention_plain(x["q"], x["k"], x["v"], b0,
                                    MAIN_D ** -0.5, x["rot"]))
    q_seg, kv_seg = fk.segment_ids_from_mask(m1, MAIN_N)
    check("flash_attention (G)",
          fk.flash_attention(x["qk0"], x["qk1"], x["v1"], q_seg, kv_seg, 1.0),
          fk.flash_attention_plain(x["qk0"], x["qk1"], x["v1"], q_seg,
                                   kv_seg, 1.0))


def check_adaptive_cpu_vs_gpu():
    """A tiny float32 adaptive LightGlue (3 layers, 128 tokens, 2 heads of
    64: kernels A and B on the card, their plain versions on the CPU) at
    the reference's defaults and in the steered regimes: exit layers,
    surviving masks and matches equal on both devices."""
    from ei_nexus_tpu_torch.models.layers import init_parameters
    from ei_nexus_tpu_torch.models.lightglue import (LightGlue,
                                                     LightGlueConfig)
    rng = np.random.default_rng(12)
    B, N, D = 2, 128, 128

    def feats():
        valid = rng.uniform(size=(B, N)) > 0.1
        return {"sparse_descriptors": torch.as_tensor(
                    rng.normal(size=(B, N, D)).astype(np.float32)),
                "sparse_positions": torch.as_tensor(np.concatenate(
                    [rng.uniform(0, 60, (B, N, 2)),
                     rng.uniform(0, 1, (B, N, 1))], -1).astype(np.float32)),
                "sparse_valid": torch.as_tensor(valid),
                "image_size": torch.full((B, 2), 64.0)}

    f0, f1 = feats(), feats()
    for regime, extra in (("defaults", ADAPTIVE),) + tuple(REGIMES.items()):
        cfg = LightGlueConfig(input_dim=D, descriptor_dim=D, n_layers=3,
                              num_heads=2, **extra)
        model = LightGlue(cfg)
        init_parameters(model, torch.Generator().manual_seed(2))
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
                elif regime == "prune_half":
                    mat.fill_(-4.0)
        model.eval()
        with torch.inference_mode():
            c = model(f0, f1)
            g = model.cuda()({k: v.cuda() for k, v in f0.items()},
                             {k: v.cuda() for k, v in f1.items()})
        for k in ("exit_layer", "surviving0", "surviving1", "matches0",
                  "matches1"):
            require(torch.equal(g[k].cpu(), c[k]),
                    f"[adaptive tiny {regime}] {k} differs CPU vs card")
        e = max_err(g["log_assignment"].cpu(), c["log_assignment"])
        print(f"[adaptive] tiny float32 {regime}: exit after layer "
              f"{int(c['exit_layer'])}, {int(c['surviving0'].sum())} + "
              f"{int(c['surviving1'].sum())} surviving, "
              f"{int((c['matches0'] > -1).sum())} matches, equal on the CPU "
              f"and the card (log-assignment max|err| {e:.2e})")


# ---------------------------------------------------------------------------
# phase 13: the SLAM back end
# ---------------------------------------------------------------------------

# tools/bench_ba.py's defaults
BA_KF, BA_LM, BA_OBS_PER, BA_ITERS, BA_CG = 512, 65536, 10, 12, 20
BA_HUBER, BA_ZMIN = 4.0, 0.01


def _rotmats(w: np.ndarray) -> np.ndarray:
    """Rodrigues in float32 numpy, (M, 3) -> (M, 3, 3)."""
    th = np.linalg.norm(w, axis=-1, keepdims=True) + 1e-12
    k = w / th
    K = np.zeros((len(w), 3, 3), np.float32)
    K[:, 0, 1], K[:, 0, 2] = -k[:, 2], k[:, 1]
    K[:, 1, 0], K[:, 1, 2] = k[:, 2], -k[:, 0]
    K[:, 2, 0], K[:, 2, 1] = -k[:, 1], k[:, 0]
    th = th[..., None]
    return (np.eye(3, dtype=np.float32)[None] + np.sin(th) * K
            + (1 - np.cos(th)) * (K @ K)).astype(np.float32)


def ba_problem(rng, M: int, L: int, obs_per: int, device="cuda",
               noise_pose=0.01, noise_point=0.05, noise_px=0.3):
    """tools/bench_ba.py's synthetic problem (a smooth forward trajectory
    with gentle yaw, landmarks ahead, each seen from `obs_per` keyframes
    near it, the rotation and camera centre perturbed and t recomposed)
    as the port's BAProblem on `device`."""
    from ei_nexus_tpu_torch.parallel.ba import BAProblem
    intr = np.tile(np.array([300.0, 300.0, 160.0, 120.0], np.float32),
                   (M, 1))
    s = np.arange(M, dtype=np.float32)
    w = np.stack([0.02 * np.sin(s * 0.05), 0.05 * np.sin(s * 0.03),
                  np.zeros(M, np.float32)], -1)
    centers = np.stack([0.5 * s, 0.2 * np.sin(s * 0.1),
                        np.zeros(M, np.float32)], -1)
    points = np.stack([rng.uniform(-5, 0.5 * M + 5, L),
                       rng.uniform(-6, 6, L),
                       rng.uniform(4, 12, L)], -1).astype(np.float32)
    R = _rotmats(w)
    t = -np.einsum("mij,mj->mi", R, centers)
    base = np.clip((points[:, 0] / 0.5).astype(np.int64), 0, M - 1)
    off = rng.integers(-8, 9, (L, obs_per))
    obs_pose = np.clip(base[:, None] + off, 0, M - 1).reshape(-1)
    obs_point = np.repeat(np.arange(L, dtype=np.int64), obs_per)
    Xc = np.einsum("oij,oj->oi", R[obs_pose], points[obs_point]) \
        + t[obs_pose]
    z = np.maximum(Xc[:, 2], 1e-3)
    uv = np.stack([intr[0, 0] * Xc[:, 0] / z + intr[0, 2],
                   intr[0, 1] * Xc[:, 1] / z + intr[0, 3]], -1)
    valid = Xc[:, 2] > 0.5
    uv = uv + rng.normal(0, noise_px, uv.shape)
    w_n, c_n = w.copy(), centers.copy()
    w_n[1:] += rng.normal(0, noise_pose, (M - 1, 3)).astype(np.float32)
    c_n[1:] += rng.normal(0, noise_pose, (M - 1, 3)).astype(np.float32)
    R_n = _rotmats(w_n.astype(np.float32))
    t_n = -np.einsum("mij,mj->mi", R_n, c_n)
    init = np.concatenate([w_n, t_n], -1).astype(np.float32)
    fixed = np.zeros(M, bool)
    fixed[0] = True

    def T(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return BAProblem(
        poses=T(init, torch.float32), intrinsics=T(intr, torch.float32),
        points=T(points + rng.normal(0, noise_point, points.shape),
                 torch.float32),
        obs_pose=T(obs_pose, torch.int32), obs_point=T(obs_point,
                                                       torch.int32),
        obs_uv=T(uv, torch.float32), obs_valid=T(valid, torch.bool),
        fixed_poses=T(fixed, torch.bool))


def phase_ba():
    """(13a) `ba_solve` at tools/bench_ba.py's defaults: 512 keyframes,
    65,536 landmarks, 10 observations each, 12 LM iterations of 20 CG
    steps, Huber 4 px, z_min 0.01, float32: the cost falls; ms per LM
    iteration (CUDA events, the slope between 3 and 12 iterations as
    bench_ba.py takes it, best of 2), the card's busy time in a solve of
    one iteration by kernel (torch.profiler), the host syncs PyTorch
    reports in a solve, peak memory. Returns a dict of the numbers."""
    from ei_nexus_tpu_torch.parallel.ba import ba_solve

    prob = ba_problem(np.random.default_rng(0), BA_KF, BA_LM, BA_OBS_PER)
    O = prob.obs_uv.shape[0]
    kw = dict(cg_iters=BA_CG, huber_delta=BA_HUBER, z_min=BA_ZMIN)

    def run(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = ba_solve(prob, iters=iters, **kw)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end), out

    run(3)                                      # warm
    torch.cuda.reset_peak_memory_stats()
    t_long, (refined, errs) = min((run(BA_ITERS) for _ in range(2)),
                                  key=lambda r: r[0])
    peak = torch.cuda.max_memory_allocated() / 1e9
    t_short = min(run(3)[0] for _ in range(2))
    per_iter = (t_long - t_short) / (BA_ITERS - 3)
    _, syncs, where = count_syncs(
        lambda: ba_solve(prob, iters=BA_ITERS, **kw))
    # the card's time in one LM iteration (with the initial cost), by
    # kernel (torch.profiler)
    times = device_ms(lambda: ba_solve(prob, iters=1, **kw), iters=3)
    busy = sum(times.values())
    top = sorted(times.items(), key=lambda kv: -kv[1])[:5]
    print(f"[ba] one LM iteration: the card busy {busy:.3f} ms; by kernel: "
          + "; ".join(f"{n[:60]} {ms:.3f}" for n, ms in top))
    errs = errs.cpu().numpy()
    print(f"[ba] {BA_KF} keyframes, {BA_LM} landmarks, {O} observations "
          f"({int(prob.obs_valid.sum())} valid), {BA_ITERS} LM x {BA_CG} CG, "
          f"Huber {BA_HUBER}, z_min {BA_ZMIN}: cost {errs[0]:.4f} -> "
          f"{errs[-1]:.4f} ({', '.join(f'{e:.4f}' for e in errs[1:4])}, "
          f"...); {per_iter:.3f} ms per LM iteration (slope; {t_long:.1f} ms "
          f"for {BA_ITERS}), {syncs} host syncs in a solve, peak "
          f"{peak:.2f} GB")
    require(np.isfinite(errs).all() and errs[-1] < errs[0],
            f"the BA cost did not fall: {errs}")
    return {"ms_per_iter": per_iter, "ms_total": t_long, "syncs": syncs,
            "busy_ms_one_iter": busy,
            "peak_gb": peak, "cost": (float(errs[0]), float(errs[-1])),
            "observations": O}


def _ring_problem(rng, M=6, L=120, device="cpu"):
    """A small exact problem (tests/test_ba.py's ring of cameras around a
    landmark cloud, noisy initialisation)."""
    from ei_nexus_tpu_torch.parallel.ba import BAProblem
    intr = np.tile(np.array([300.0, 300.0, 160.0, 120.0]), (M, 1))
    points = rng.uniform([-2, -2, 4], [2, 2, 8], (L, 3))
    w = np.stack([[0.0, 0.05 * m, 0.0] for m in range(M)])
    R = _rotmats(w.astype(np.float32)).astype(np.float64)
    t = -np.einsum("mij,mj->mi", R, np.stack(
        [[0.3 * m - 0.75, 0.0, 0.0] for m in range(M)]))
    Xc = np.einsum("mij,lj->mli", R, points) + t[:, None]
    uv = np.stack([300.0 * Xc[..., 0] / Xc[..., 2] + 160.0,
                   300.0 * Xc[..., 1] / Xc[..., 2] + 120.0], -1)
    init = np.concatenate([w, t], -1)
    init[1:] += rng.normal(0, 0.02, (M - 1, 6))
    fixed = np.zeros(M, bool)
    fixed[0] = True

    def T(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return BAProblem(
        poses=T(init, torch.float32), intrinsics=T(intr, torch.float32),
        points=T(points + rng.normal(0, 0.05, points.shape), torch.float32),
        obs_pose=T(np.repeat(np.arange(M), L), torch.int32),
        obs_point=T(np.tile(np.arange(L), M), torch.int32),
        obs_uv=T(uv.reshape(-1, 2), torch.float32),
        obs_valid=torch.ones(M * L, dtype=torch.bool, device=device),
        fixed_poses=T(fixed, torch.bool))


def phase_ba_cpu_vs_gpu():
    """(13b) A small exact problem (6 keyframes, 120 landmarks) solved on
    the CPU and the card, plain and with Huber 4 px and z_min 0.01: the
    initial costs to rtol 1e-5; the first iteration's to 1e-4 of the
    initial cost (that step leaves ~3e-4 of it, which carries the
    summation order: the card's atomic `index_add_` changes it from run to
    run, by 1.3% and 3.5% of its value in two runs); refined poses to atol
    1e-4, points to atol 1e-3 (tests/test_torch_ba.py's bounds against
    JAX); both converge below 1e-3 px^2. (13c) `pose_graph_solve` on an
    8-pose ring with a loop closure: its residuals fall below 5% in 100
    steps, on the card."""
    from ei_nexus_tpu_torch.parallel import ba as tba

    prob = _ring_problem(np.random.default_rng(13))
    for kw in ({}, dict(huber_delta=BA_HUBER, z_min=BA_ZMIN)):
        rc, ec = tba.ba_solve(prob, iters=10, cg_iters=25, **kw)
        rg, eg = tba.ba_solve(prob.to("cuda"), iters=10, cg_iters=25, **kw)
        eg, rg = eg.cpu().numpy(), rg.to("cpu")
        ec = ec.numpy()
        e_pose = max_err(rg.poses, rc.poses)
        e_point = max_err(rg.points, rc.points)
        print(f"[ba] small problem {kw or 'plain'}: cost {ec[0]:.4f} -> "
              f"{ec[-1]:.2e} (CPU), {eg[0]:.4f} -> {eg[-1]:.2e} (card); "
              f"first iteration {ec[1]:.4e} / {eg[1]:.4e}; poses max|err| "
              f"{e_pose:.2e}, points {e_point:.2e}")
        require(abs(eg[0] - ec[0]) <= 1e-5 * ec[0], "initial costs differ")
        require(abs(eg[1] - ec[1]) <= 1e-4 * ec[0], "first steps differ")
        require(e_pose <= 1e-4 and e_point <= 1e-3,
                "refined problems differ CPU vs card")
        require(ec[-1] < 1e-3 and eg[-1] < 1e-3, "no convergence")

    rng = np.random.default_rng(14)
    M = 8
    gt = np.zeros((M, 6), np.float32)
    gt[:, 4] = np.linspace(0, 1.0, M)
    gt[:, 1] = np.linspace(0, 0.3, M)
    ei = list(range(M - 1)) + [M - 1]
    ej = list(range(1, M)) + [0]
    g = torch.as_tensor(gt)
    rels = tba._pose_compose(g[ej], tba._pose_inv(g[ei]))
    init = gt.copy()
    init[1:] += rng.normal(0, 0.05, (M - 1, 6)).astype(np.float32)
    fixed = torch.zeros(M, dtype=torch.bool)
    fixed[0] = True
    graph = tba.PoseGraph(torch.as_tensor(init), torch.as_tensor(ei),
                          torch.as_tensor(ej), rels, torch.ones(len(ei)),
                          fixed).to("cuda")
    r0 = float((tba.pose_graph_residuals(graph) ** 2).sum())
    solved, costs = tba.pose_graph_solve(graph, iters=100)
    r1 = float((tba.pose_graph_residuals(solved) ** 2).sum())
    print(f"[pose-graph] {M} poses, {len(ei)} edges (one loop closure): "
          f"squared residuals {r0:.4e} -> {r1:.4e} in 100 steps on the card")
    require(r1 < 0.05 * r0, f"pose graph residuals {r0} -> {r1}")
    require(bool(torch.equal(solved.poses[0], graph.poses[0])),
            "the gauge pose moved")


def umeyama_ate(est: np.ndarray, gt: np.ndarray) -> float:
    """Camera-centre RMSE after a similarity alignment (the gauge of
    monocular BA: first pose fixed, scale free), as tools/slam_mvsec.py
    takes it."""
    mu_e, mu_g = est.mean(0), gt.mean(0)
    E, G = est - mu_e, gt - mu_g
    U, S, Vt = np.linalg.svd(E.T @ G)
    D = np.eye(3)
    if np.linalg.det(U @ Vt) < 0:
        D[2, 2] = -1
    R = U @ D @ Vt
    s = (S * np.diag(D)).sum() / max((E ** 2).sum(), 1e-12)
    aligned = s * (E @ R) + mu_g
    return float(np.sqrt(((aligned - gt) ** 2).sum(-1).mean()))


def _centers(poses6: np.ndarray) -> np.ndarray:
    R = _rotmats(poses6[:, :3].astype(np.float32))
    return -np.einsum("mij,mi->mj", R, poses6[:, 3:])


SLAM_KF, SLAM_TOPK, SLAM_STRIDE = 40, 512, 64   # slam_mvsec's --frames 40


def slam_scene(rng, drift=0.005):
    """A synthetic drifted trajectory: 40 keyframes 0.25 apart along x
    with gentle yaw, each seeing 512 landmarks (ids f*64 .. f*64+511, ahead
    at depth 3-8) as keypoints at MVSEC's intrinsics with 0.5 px noise;
    consecutive keyframes share 448, matched by id. The initial poses
    accumulate noisy relative motions (`drift` rad and units a step) from
    the first, as tools/slam_mvsec.py drifts them. Returns (keyframes at
    the drifted poses, matches01, the true camera centres)."""
    from ei_nexus_tpu_torch.parallel.slam import Keyframe
    K = np.array([[226.4, 0, 173.1], [0, 226.4, 130.5], [0, 0, 1]],
                 np.float32)
    M, P, S = SLAM_KF, SLAM_TOPK, SLAM_STRIDE
    n_lm = S * (M - 1) + P
    s = np.arange(M, dtype=np.float32)
    w = np.stack([np.zeros(M), 0.03 * np.sin(s * 0.1), np.zeros(M)],
                 -1).astype(np.float32)
    centers = np.stack([0.25 * s, np.zeros(M), np.zeros(M)], -1)
    R = _rotmats(w).astype(np.float64)
    P_true = np.tile(np.eye(4), (M, 1, 1))
    P_true[:, :3, :3] = R
    P_true[:, :3, 3] = -np.einsum("mij,mj->mi", R, centers)
    # landmark j is seen by keyframes j // S - 7 .. j // S: place it ahead
    # of the middle one
    mid = np.clip(np.arange(n_lm) // S - 3, 0, M - 1)
    depth = rng.uniform(3, 8, n_lm)
    lm_c = np.stack([rng.uniform(-0.6, 0.6, n_lm) * depth,
                     rng.uniform(-0.45, 0.45, n_lm) * depth, depth], -1)
    X = np.einsum("lji,lj->li", R[mid], lm_c) + centers[mid]
    kfs_true, kps = [], []
    for f in range(M):
        ids = f * S + np.arange(P)
        Xc = X[ids] @ R[f].T + P_true[f, :3, 3]
        uv = Xc @ K.T.astype(np.float64)
        uv = uv[:, :2] / uv[:, 2:] + rng.normal(0, 0.5, (P, 2))
        kps.append(np.concatenate([uv[:, ::-1], np.ones((P, 1))],
                                  1).astype(np.float32))
    drifted = [P_true[0]]
    for f in range(1, M):
        rel = P_true[f] @ np.linalg.inv(P_true[f - 1])
        noise = np.eye(4)
        noise[:3, :3] = _rotmats(rng.normal(0, drift, (1, 3)).astype(
            np.float32))[0]
        noise[:3, 3] = rng.normal(0, drift, 3)
        drifted.append(noise @ rel @ drifted[-1])
    kfs = [Keyframe(keypoints=kps[f], valid=np.ones(P, bool),
                    pose=drifted[f].astype(np.float32), K=K)
           for f in range(M)]
    matches01 = [np.where(np.arange(P) >= S, np.arange(P) - S, -1)
                 for _ in range(M - 1)]
    return kfs, matches01, centers


def phase_slam():
    """(13d) `refine_map` on a synthetic drifted trajectory of 40
    keyframes with 512 keypoints each (tools/slam_mvsec.py's --frames 40
    --topk 512): tracks chained, triangulated on the card, bundle-adjusted
    (10 LM iterations): the cost falls; ATE (Umeyama) before and after.
    (13e) The front end's wiring: the stage-1 MNN model (C 2) on 8
    synthetic frames at full width, its matcher's matches0 between
    consecutive frames' event keypoints into `chain_tracks` ->
    `build_ba_problem` -> `ba_solve` (Cauchy 2 px, z_min 0.05, as
    slam_mvsec.py solves): finite costs; random weights make no accuracy
    claim. Returns the numbers."""
    from ei_nexus_tpu_torch.models.eim import EIM
    from ei_nexus_tpu_torch.models.layers import init_parameters
    from ei_nexus_tpu_torch.parallel import ba as tba
    from ei_nexus_tpu_torch.parallel.slam import (Keyframe, _so3log_np,
                                                  build_ba_problem,
                                                  chain_tracks, refine_map)
    from ei_nexus_tpu_torch.train.steps import batch_representation

    kfs, matches01, gt = slam_scene(np.random.default_rng(15))
    t = time.perf_counter()
    refined, errs = refine_map(kfs, matches01, iters=10, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    tracks = chain_tracks(matches01, SLAM_TOPK)
    init6 = np.stack([np.concatenate([_so3log_np(k.pose[:3, :3]),
                                      k.pose[:3, 3]]) for k in kfs])
    ate0 = umeyama_ate(_centers(init6), gt)
    ate1 = umeyama_ate(_centers(refined.poses.cpu().numpy()), gt)
    print(f"[slam] refine_map: {SLAM_KF} keyframes x {SLAM_TOPK} keypoints, "
          f"{len(tracks)} tracks, {refined.obs_uv.shape[0]} observations: "
          f"cost {errs[0]:.4f} -> {errs[-1]:.4f} in 10 iterations, "
          f"{wall:.2f} s wall (chaining, triangulation and BA); ATE "
          f"{ate0:.4f} -> {ate1:.4f} (Umeyama, trajectory length "
          f"{0.25 * (SLAM_KF - 1):.2f})")
    require(np.isfinite(errs).all() and errs[-1] < errs[0],
            f"refine_map's cost did not fall: {errs}")
    require(ate1 < ate0, f"refine_map left the ATE at {ate1} >= {ate0}")

    cfg, (H, W, bins) = mnn_config()
    model = EIM(cfg)
    init_parameters(model, torch.Generator().manual_seed(0))
    model = model.cuda().eval()
    ev, image = flagship_inputs()
    with torch.inference_mode():
        rep, mask = batch_representation(ev, "VoxelGrid", bins, H, W)
        launches, (feats, _, _) = _read_launches(
            lambda: model(rep, image, mask), "slam front end",
            {"nms_rounds": 2})

        def frame(f):
            return {k: v[f:f + 1] for k, v in feats.items()
                    if torch.is_tensor(v) and v.shape[:1] == (8,)}

        m01 = [model.matcher(frame(f), frame(f + 1))["matches0"][0]
               .cpu().numpy() for f in range(7)]
    Kf = np.array([[226.4, 0, 173.1], [0, 226.4, 130.5], [0, 0, 1]],
                  np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (8, 1, 1))
    poses[:, 0, 3] = -0.1 * np.arange(8)
    pos = feats["sparse_positions"].float().cpu().numpy()
    valid = feats["sparse_valid"].cpu().numpy()
    fkfs = [Keyframe(pos[f], valid[f], poses[f], Kf) for f in range(8)]
    ftracks = chain_tracks(m01, pos.shape[1])
    prob = build_ba_problem(fkfs, ftracks, device="cuda")
    require(prob is not None, "the front end gave no track")
    # slam_mvsec.py's gate: drop every landmark with an observation behind
    # a camera or 40 px off at the initial poses
    r0 = tba.residuals(prob).norm(dim=-1)
    bad = (tba._obs_z(prob) < 0.05) | (r0 > 40.0)
    bad_lm = torch.zeros(prob.points.shape[0], dtype=torch.bool,
                         device="cuda").index_put_(
        (prob.obs_point.long()[bad],), torch.tensor(True, device="cuda"))
    prob = prob._replace(obs_valid=prob.obs_valid
                         & ~bad_lm[prob.obs_point.long()])
    _, ferrs = tba.ba_solve(prob, iters=6, huber_delta=2.0, robust="cauchy",
                            z_min=0.05)
    ferrs = ferrs.cpu().numpy()
    print(f"[slam] front end: the stage-1 MNN model on 8 frames (C "
          f"{launches['nms_rounds']}), "
          f"{np.mean([(m > -1).sum() for m in m01]):.0f} matches a pair, "
          f"{len(ftracks)} tracks, {int(prob.obs_valid.sum())} of "
          f"{prob.obs_uv.shape[0]} observations kept by the gate; "
          f"BA costs {ferrs[0]:.4f} -> {ferrs[-1]:.4f} (random weights: no "
          f"accuracy claim)")
    require(np.isfinite(ferrs).all(), f"non-finite front-end costs {ferrs}")
    return {"ate": (ate0, ate1), "cost": (float(errs[0]), float(errs[-1])),
            "tracks": len(tracks), "wall_s": wall,
            "front_end_tracks": len(ftracks)}


# ---------------------------------------------------------------------------
# phase 14: the multi-process slice
# ---------------------------------------------------------------------------

DP_WORLD = 2        # gloo ranks on the one card (14b)
DP_TIMED = 10       # steps timed back to back at world size 1 and 2
# bfloat16 bounds of one rank against two (14b): the ranks' halves go
# through cuBLAS and cuDNN at another batch size (other algorithms, other
# rounding of bf16 products) and the sums meet in another order: loss
# 1e-3 and grad_norm 1e-2 relative, running statistics 1e-3 x max(1, |r|)
# (a tenth of a batch statistic's bf16 rounding, momentum 0.9), parameters
# 3 lr (Adam's first step moves one by about lr whatever its gradient);
# the stage-1 loss 2^-8 relative: its terms are means of bfloat16 maps,
# themselves bfloat16 (a rank's half rounds apart from the whole batch).
# The gradient, leaf by leaf (`grad_gap`): stage 2 a leaf's largest error
# 0.2 of its largest value and the whole difference's relative norm 3e-2
# (2.7e-2 and 5.7e-2, 8.9e-3 and 9.3e-3 seen in two calls; grad_norm's
# relative gap has ranged 8x over calls); stage 1 0.75 and 5e-2 (0.23 and
# 0.26, 1.5e-2 seen: the full-width extractor's gradient is
# ill-conditioned, as reversing a batch's rows moves it by 7e-3 of a
# leaf's largest in float32). A gradient swapped
# between leaves, a mis-split all-reduce or a sum left unaveraged moves a
# leaf by its own size.
DP_LOSS_REL, DP_GNORM_REL, DP_STAT_TOL, DP_PARAM_LRS = 1e-3, 1e-2, 1e-3, 3.0
DP_S1_LOSS_REL = 2.0 ** -8
DP_GRAD_LEAF, DP_GRAD_NORM = 0.2, 3e-2
DP_S1_GRAD_LEAF, DP_S1_GRAD_NORM = 0.75, 5e-2


def grad_gap(got: dict, want: dict) -> tuple:
    """Two gradients by leaf name: (the largest elementwise error of a
    leaf over the larger of its largest |want| and a hundredth of the
    largest leaf's, the relative norm of the whole difference)."""
    require(set(got) == set(want), "the gradients' leaves differ")
    floor = 1e-2 * max(float(w.abs().max()) for w in want.values())
    leaf = max(float((got[k] - w).abs().max())
               / max(float(w.abs().max()), floor) for k, w in want.items())
    num = sum(float((got[k] - w).square().sum()) for k, w in want.items())
    den = sum(float(w.square().sum()) for w in want.values())
    return leaf, (num / den) ** 0.5


def check_path_kernels(run) -> dict:
    """One more step, run(), with the first inputs that D, F and C take on
    it recorded (`record_kernel_inputs`); each of those kernels then called
    again on those tensors and held against its plain version at phase 2's
    tolerances (D and F 2e-2 x max(1, max|ref|) in bfloat16; C
    bit-exact), F also within BWD_REL's relative norm of
    `attention_bwd_plain_from_out`, the plain version with c read from
    D's output as F reads it. These launches are made after the path's
    were counted. Returns {name: (shape, max abs err[, F's relative norm
    against that version and against the plain one])} of the kernels the
    step ran."""
    from ei_nexus_tpu_torch.ops import attention_kernels as ak
    from ei_nexus_tpu_torch.ops import detector

    seen = record_kernel_inputs(run, ((ak, "attention_fwd"),
                                      (ak, "attention_bwd"),
                                      (detector, "nms_rounds")))
    with torch.no_grad():
        return _hold_path_kernels(seen)


def record_kernel_inputs(run, targets) -> dict:
    """run() with each kernel wrapper of `targets` ((module, name): where
    the path looks the wrapper up) called through a recorder; returns
    {name: (args, kwargs) of its first call}."""
    seen = {}
    real = {(mod, name): getattr(mod, name) for mod, name in targets}

    def recorder(name, fn):
        def rec(*args, **kw):
            seen.setdefault(name, (args, kw))
            return fn(*args, **kw)
        # the real wrapper counts under its module's name: this one, now
        rec.launches = 0
        return rec

    for (mod, name), fn in real.items():
        setattr(mod, name, recorder(name, fn))
    try:
        run()
        torch.cuda.synchronize()
    finally:
        for (mod, name), fn in real.items():
            setattr(mod, name, fn)
    return seen


def _attention_gap(name: str, got, want, dtype) -> float:
    """The largest error of a kernel's outputs against its plain
    version's, each held to ATTN_TOL[dtype] x max(1, max|ref|)."""
    e = 0.0
    for g, w in zip(got, want):
        err = max_err(g, w)
        tol = ATTN_TOL[dtype] * max(1.0, float(w.float().abs().max()))
        require(err <= tol, f"{name} disagrees: {err:.3e} > {tol:.3e}")
        e = max(e, err)
    return e


def _hold_path_kernels(seen: dict) -> dict:
    from ei_nexus_tpu_torch.ops import attention_kernels as ak
    from ei_nexus_tpu_torch.ops import nms_kernel as nk

    out = {}
    if "attention_fwd" in seen:
        (q, k, v, bias, scale), _ = seen["attention_fwd"]
        got = ak.attention_fwd(q, k, v, bias, scale)[0]
        want = ak.fused_attention_plain(q, k, v, bias == 0, scale)
        out["attention_fwd"] = (list(q.shape), _attention_gap(
            f"attention_fwd at {tuple(q.shape)}", (got,), (want,), q.dtype))
    if "attention_bwd" in seen:
        (q, k, v, o, do, bias, stats, scale), _ = seen["attention_bwd"]
        got = ak.attention_bwd(q, k, v, o, do, bias, stats, scale)
        plain = ak.fused_attention_bwd_plain(q, k, v, bias, do, scale)
        from_out = attention_bwd_plain_from_out(q, k, v, o, do, bias,
                                                    scale)
        e = rel = rel_plain = 0.0
        for name, a, b, c in zip(("dq", "dk", "dv"), got, from_out, plain):
            bound = ATTN_TOL[q.dtype] * max(1.0,
                                            float(b.float().abs().max()))
            err, r = max_err(a, b), rel_err(a, b)
            err_plain = max_err(a, c)
            require(err <= bound and r <= BWD_REL[q.dtype]
                    and err_plain <= bound,
                    f"attention_bwd {name} at {tuple(q.shape)} disagrees: "
                    f"{err:.3e} (bound {bound:.3e}), relative norm {r:.3e}; "
                    f"against the plain version {err_plain:.3e}")
            e, rel = max(e, err), max(rel, r)
            rel_plain = max(rel_plain, rel_err(a, c))
        out["attention_bwd"] = (list(q.shape), e, rel, rel_plain)
    if "self_attention" in seen:
        (q, k, v, *mask), kw = seen["self_attention"]
        kv_mask = mask[0] if mask else kw.get("kv_mask")
        got = ak.self_attention(q, k, v, kv_mask, rot=kw.get("rot"),
                                block_q=kw.get("block_q", 0))
        want = ak.self_attention_plain(q, k, v, kv_mask, kw.get("rot"))
        out["self_attention_rot"] = (list(q.shape), _attention_gap(
            f"self_attention at {tuple(q.shape)}", (got,), (want,),
            q.dtype))
    if "cross_attention_bidir" in seen:
        (qk0, qk1, v0, v1, *masks), kw = seen["cross_attention_bidir"]
        masks = (masks + [None, None])[:2]
        got = ak.cross_attention_bidir(qk0, qk1, v0, v1, *masks,
                                       block_q=kw.get("block_q", 0))
        want = ak.cross_attention_bidir_plain(qk0, qk1, v0, v1, *masks)
        out["cross_attention_bidir"] = (list(qk0.shape), _attention_gap(
            f"cross_attention_bidir at {tuple(qk0.shape)}", got, want,
            qk0.dtype))
    if "nms_rounds" in seen:
        (x, radius, rounds), _ = seen["nms_rounds"]
        require(torch.equal(nk.nms_rounds(x, radius, rounds),
                            nk.nms_rounds_plain(x, radius, rounds)),
                f"nms_rounds at {tuple(x.shape)} is not bit-exact")
        out["nms_rounds"] = (list(x.shape), 0.0)
    return out


def attention_bwd_plain_from_out(q, k, v, out, do, bias, scale):
    """Kernel F's function as `attention_kernels` states it: the plain
    version's (dq, dk, dv) with c = rowsum(dO o O) read from D's output
    `out`, as F reads it, where the plain version takes rowsum(dP o P).
    The two agree but for O's rounding, which rules dQ and dK where a row's
    softmax is near one-hot and dP - c cancels."""
    do = do.to(q.dtype)
    s = torch.matmul(q.float(), k.float().mT) * scale + bias[:, None, None]
    p = torch.softmax(s, dim=-1)
    dp = torch.matmul(do.float(), v.float().mT)
    c = (do.float() * out.float()).sum(dim=-1, keepdim=True)
    ds = (p * (dp - c)).to(q.dtype).float()
    dq = (torch.matmul(ds, k.float()) * scale).to(q.dtype)
    dv = torch.matmul(p.to(do.dtype).float().mT, do.float()).to(v.dtype)
    dk = (torch.matmul(ds.mT, q.float()) * scale).to(k.dtype)
    return dq, dk, dv


def _dp_stage2(data, model, cfg, sd, batch, timed):
    """The stage-2 step over a (data, model) mesh on its rows of the global
    batch, the fill drawn for the global batch from a generator seeded 1
    (`dryrun.stage2_setup`): `dryrun.first_step` (launches, info, the
    gradient, rank 0's state dict, kept to the matcher's tensors); then
    D, F and C checked on the tensors a second step hands them
    (`check_path_kernels`); with `timed`, ms per step back to back and, in
    a second pass with the card synchronised around each collective, the
    collectives' ms per step."""
    from ei_nexus_tpu_torch.parallel import dryrun
    from ei_nexus_tpu_torch.train import steps as st

    state, run = dryrun.stage2_setup(data, model, "cuda", cfg, sd, batch)
    out = dryrun.first_step(state, lambda: run(None, 1))
    torch.cuda.synchronize()
    if "state_dict" in out:
        out["state_dict"] = {k: v.float() for k, v in
                             out.pop("state_dict").items()
                             if k.startswith("matcher.")}
    out["path_kernels"] = check_path_kernels(lambda: run(None, 1))
    if timed:
        def steps():
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(DP_TIMED):
                run(None, 1)
            torch.cuda.synchronize()
            return (time.perf_counter() - t) * 1e3 / DP_TIMED

        steps()
        out["ms"] = steps()
        spent = [0.0]
        real = (st._reduce_gradients, st._global_info)

        def synced(fn):
            def wrapper(*a):
                torch.cuda.synchronize()
                t = time.perf_counter()
                r = fn(*a)
                torch.cuda.synchronize()
                spent[0] += time.perf_counter() - t
                return r
            return wrapper

        st._reduce_gradients, st._global_info = (synced(f) for f in real)
        try:
            out["ms_synced"] = steps()
        finally:
            st._reduce_gradients, st._global_info = real
        out["collective_ms"] = spent[0] * 1e3 / DP_TIMED
    return out


def _dp_stage1(data, cfg, sd, batch):
    """The stage-1 step over a (data, 1) mesh (global BatchNorm
    statistics, global mask counts; `dryrun.stage1_setup`):
    `dryrun.first_step`, rank 0's state dict kept to the event extractor's
    running statistics, and this rank's event-mask count."""
    from ei_nexus_tpu_torch.flagship import STAGE1_LOSSES
    from ei_nexus_tpu_torch.parallel import dryrun
    from ei_nexus_tpu_torch.parallel.mesh import shard_batch
    from ei_nexus_tpu_torch.train.steps import batch_representation

    state, run = dryrun.stage1_setup(data, "cuda", cfg, sd, batch,
                                     STAGE1_LOSSES)
    H, W = batch[0]["image"].shape[1:3]
    _, mask = batch_representation(shard_batch(batch, state.mesh)[0],
                                   "VoxelGrid",
                                   cfg.event_extractor.in_channels, H, W,
                                   device=state.mesh.device)
    out = dryrun.first_step(state, run)
    out["mask_count"] = int(mask.sum())
    if "state_dict" in out:
        out["stats"] = {k: v.float() for k, v in
                        out.pop("state_dict").items()
                        if k.endswith(("running_mean", "running_var"))}
    return out


def _dp_lightglue(mesh, cfg, sd, feats0, feats1):
    """LightGlue's inference forward under `mesh` (its heads split over
    the model group): rank 0's log-assignment in float32."""
    from ei_nexus_tpu_torch.models.lightglue import LightGlue
    from ei_nexus_tpu_torch.parallel.mesh import shard_batch, use_mesh

    with use_mesh(mesh):
        lg = LightGlue(cfg)
        lg.load_state_dict(sd, strict=True)
        lg = lg.to(mesh.device).eval()
        with torch.no_grad():
            out = lg(shard_batch(feats0, mesh), shard_batch(feats1, mesh))
    return out["log_assignment"].float().cpu() if mesh.rank == 0 else None


def _dp_ba(group, rank, world):
    """`ba_solve` at tools/bench_ba.py's defaults, this rank holding a
    contiguous 1/world of the observations: the cost trajectory."""
    from ei_nexus_tpu_torch.parallel.ba import ba_solve

    prob = ba_problem(np.random.default_rng(0), BA_KF, BA_LM, BA_OBS_PER)
    O = prob.obs_pose.shape[0]
    chunk = slice(rank * O // world, (rank + 1) * O // world)
    prob = prob._replace(**{f: getattr(prob, f)[chunk] for f in (
        "obs_pose", "obs_point", "obs_uv", "obs_valid")})
    _, errs = ba_solve(prob, iters=BA_ITERS, cg_iters=BA_CG,
                       huber_delta=BA_HUBER, z_min=BA_ZMIN, group=group)
    return errs.cpu().numpy()


def dp_cases(data, model, inputs):
    """One rank's side of phase 14b (every case over its process group,
    or alone at world size 1: the reference): the stage-2 step over
    (data, 1), timed; the stage-1 step over (data, 1); LightGlue's forward
    and the stage-2 step with its heads split over (1, model); BA with the
    observations split over every rank."""
    import torch.distributed as dist
    from ei_nexus_tpu_torch.parallel.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tp = make_mesh(1, model, "cuda")
    out = {"stage2": _dp_stage2(data, 1, *inputs["stage2"], timed=True),
           "stage1": _dp_stage1(data, *inputs["stage1"]),
           "lightglue": _dp_lightglue(tp, *inputs["lightglue"]),
           "lightglue32": _dp_lightglue(tp, *inputs["lightglue32"]),
           "shard_stage2": _dp_stage2(1, model, *inputs["shard_stage2"],
                                      timed=False)}
    world = tp.world
    out["ba"] = _dp_ba(dist.group.WORLD if world > 1 else None, tp.rank,
                       world)
    torch.cuda.empty_cache()
    return out


def dp_inputs():
    """Phase 14b's inputs on the host, seeded: the stage-2 flagship's
    weights and a global batch of 8 (bursty events, 95% of 131,072 slots);
    the stage-1 flagship's weights and a batch of 8 whose rows keep from 5%
    to 95% of their events, so the ranks' rows (strided) carry unequal
    event masks; the flagship's LightGlue (shard_heads) with
    random keypoints of 8 pairs of 1024 slots, about 30% invalid, in
    bfloat16 and in float32; the stage-2 flagship with shard_heads."""
    from ei_nexus_tpu_torch.data.synth import bursty_event_batch, stage2_batch
    from ei_nexus_tpu_torch.flagship import stage1_config, stage2_config
    from ei_nexus_tpu_torch.models.eim import EIM
    from ei_nexus_tpu_torch.models.layers import init_parameters
    from ei_nexus_tpu_torch.models.lightglue import LightGlue

    def weights(module):
        init_parameters(module, torch.Generator().manual_seed(0))
        return {k: v.clone() for k, v in module.state_dict().items()}

    B, L = 8, 1 << 17
    cfg2, (H, W, _) = stage2_config(dtype="bfloat16")
    sd2 = weights(EIM(cfg2, training_heads=True))
    batch2 = stage2_batch(np.random.default_rng(0), B, int(L * 0.95), L, H,
                          W)
    cfg1, _ = stage1_config(dtype="bfloat16")
    sd1 = weights(EIM(cfg1))
    rng = np.random.default_rng(1)
    view = bursty_event_batch(rng, B, int(L * 0.95), L, H, W)
    for i, share in enumerate((0.95, 0.2, 0.6, 0.1, 0.8, 0.3, 0.5, 0.05)):
        view["events_valid"][i, int(L * share):] = False
    view["image"] = rng.uniform(0, 255, (B, H, W, 1)).astype(np.float32)
    cfg_s, _ = stage2_config(dtype="bfloat16", shard_heads=True)
    lg_cfg = cfg_s.matcher.lightglue
    lg_sd = weights(LightGlue(lg_cfg))
    rng = np.random.default_rng(2)
    N, D = MAIN_N, lg_cfg.descriptor_dim

    def feats():
        desc = rng.normal(size=(B, N, D)).astype(np.float32)
        desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
        pos = np.stack([rng.uniform(0, H, (B, N)), rng.uniform(0, W, (B, N)),
                        rng.uniform(0, 1, (B, N))], -1).astype(np.float32)
        return {"sparse_positions": torch.from_numpy(pos),
                "sparse_descriptors": torch.from_numpy(desc),
                "sparse_valid": torch.from_numpy(rng.uniform(size=(B, N))
                                                 > 0.3),
                "image_size": torch.tensor([[H, W]] * B, dtype=torch.float32)}

    f0, f1 = feats(), feats()
    lg32 = dataclasses.replace(lg_cfg, dtype="float32",
                               score_dtype="float32")
    return {"stage2": (cfg2, sd2, batch2), "stage1": (cfg1, sd1, (view,)),
            "lightglue": (lg_cfg, lg_sd, f0, f1),
            "lightglue32": (lg32, lg_sd, f0, f1),
            "shard_stage2": (cfg_s, sd2, batch2)}


def phase_dp_entry(data: str, tmp: str, s1_final: str) -> dict:
    """(14a) `python -m torch.distributed.run --standalone --nproc_per_node
    <cards> -m ei_nexus_tpu_torch.train_matcher` (NCCL, a card a rank) over
    phase 11's mini-EC, 4 steps of the homography route at a global batch
    of 8: exit 0, every rank printing its NCCL place, one run directory
    (rank 0's) with a `final` checkpoint at step 4. Returns the ranks and
    the process wall seconds."""
    count = torch.cuda.device_count()
    out = os.path.join(tmp, "dp_entry_runs")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(count), "-m",
           "ei_nexus_tpu_torch.train_matcher", "--config", STAGE2_CONFIG,
           "--stage1-ckpt", s1_final, "--max-steps", "4", "dataset=ec",
           f"dataset.data_path={data}", f"logger.output_dir={out}",
           "logger.status_freq=1"]
    t = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t
    if proc.returncode != 0:
        print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
    require(proc.returncode == 0, f"torchrun exited {proc.returncode}")
    for r in range(count):
        line = f"rank {r} of {count}: backend nccl, device cuda:{r}"
        require(line in proc.stdout, f"no {line!r} in the ranks' output")
    runs = [p for p in os.listdir(out)
            if os.path.isdir(os.path.join(out, p))]
    require(len(runs) == 1, f"run directories {runs}: rank 0 alone writes")
    ck = torch.load(os.path.join(out, runs[0], "checkpoints", "final",
                                 "state.pt"), map_location="cpu",
                    weights_only=True)
    require(ck["step"] == 4, f"final checkpoint at step {ck['step']}")
    with open(os.path.join(out, runs[0], "log.txt")) as f:
        log = f.read()
    require(f"rank 0 of {count}: backend nccl" in log, "no NCCL in the log")
    print(f"[dp-entry] torchrun, {count} rank(s) over NCCL: exit 0, 4 "
          f"steps in {wall:.1f} s (process wall), rank 0's run and final "
          f"checkpoint alone")
    return {"ranks": count, "wall_s": wall}


def phase_dp(world: int = DP_WORLD, backend: str = "gloo") -> dict:
    """(14b) Gloo with CUDA tensors, 2 ranks on the one card
    (`parallel/dryrun.py:launch`, spawned after the kernels were built;
    `world` ranks over `backend`, e.g. NCCL a rank a card on a host with
    `world` cards), against one process running the same cases
    (`dp_cases`): the stage-2 step at full width, global batch 8 (per rank
    D 36, F 36, C 2 and no other kernel, each then held against its plain
    version on the tensors the rank's step hands it), loss, grad_norm, the
    gradient leaf by leaf and the matcher's parameters; the stage-1 step
    with global BatchNorm statistics (unequal event masks on the ranks):
    loss, running statistics and gradient; LightGlue's forward and the
    stage-2 step with the heads split over (1, world), against the heads
    computed whole (the einsum path: C 2, no attention kernel); BA at
    tools/bench_ba.py's size over the ranks: the cost trajectory within
    phase 13b's 1e-4 of the initial cost. Every rank's gradient equals
    rank 0's. Prints steps/s at world size 1 and `world` and the
    collectives' share of the step."""
    from ei_nexus_tpu_torch.flagship import STAGE2_LR
    from ei_nexus_tpu_torch.parallel.dryrun import launch

    inputs = dp_inputs()
    t = time.perf_counter()
    two = launch(dp_cases, world, (world, world, inputs), device="cuda",
                 backend=backend, timeout_s=900)
    wall = time.perf_counter() - t
    one = dp_cases(1, 1, inputs)
    r0 = two[0]

    # the data-parallel stage-2 step
    want = {n: 0 for n in kernel_counters()}
    want.update(nms_rounds=2, attention_fwd=36, attention_bwd=36)
    for r, got in enumerate(two):
        require(got["stage2"]["launches"] == want,
                f"rank {r} launches {got['stage2']['launches']} != {want}")
        require(got["stage2"]["info"] == r0["stage2"]["info"],
                f"rank {r}'s info differs from rank 0's")
        require(set(got["stage2"]["path_kernels"]) == {
            "attention_fwd", "attention_bwd", "nms_rounds"},
            f"rank {r} checked {sorted(got['stage2']['path_kernels'])}")
    for case in ("stage2", "stage1", "shard_stage2"):
        for r, got in enumerate(two):
            require(all(torch.equal(g, r0[case]["grads"][k])
                        for k, g in got[case]["grads"].items()),
                    f"rank {r}'s {case} gradient differs from rank 0's")
    a, b = r0["stage2"]["info"], one["stage2"]["info"]
    dl = abs(a["loss"] - b["loss"]) / abs(b["loss"])
    dg = abs(a["grad_norm"] - b["grad_norm"]) / abs(b["grad_norm"])
    gl, gn = grad_gap(r0["stage2"]["grads"], one["stage2"]["grads"])
    dp = max(float((r0["stage2"]["state_dict"][k] - v).abs().max())
             for k, v in one["stage2"]["state_dict"].items())
    print(f"[dp] stage-2 step, {world} {backend} ranks x {8 // world} rows "
          f"against 1 x 8: loss "
          f"{a['loss']:.6f} / {b['loss']:.6f} (rel {dl:.2e}), grad_norm "
          f"{a['grad_norm']:.6f} / {b['grad_norm']:.6f} (rel {dg:.2e}), "
          f"gradient: largest leaf error {gl:.3e} of the leaf's largest, "
          f"relative norm {gn:.3e}; max |param diff| {dp:.2e} "
          f"({dp / STAGE2_LR:.2f} lr); launches a rank "
          f"{r0['stage2']['launches']}")
    for r, got in enumerate(two):
        print(f"[dp] rank {r}: the path's kernels on its own tensors "
              f"against their plain versions (shape, max|err|): "
              + json.dumps(got["stage2"]["path_kernels"]))
    require(dl <= DP_LOSS_REL and dg <= DP_GNORM_REL
            and gl <= DP_GRAD_LEAF and gn <= DP_GRAD_NORM
            and dp <= DP_PARAM_LRS * STAGE2_LR, "stage-2 world 2 != world 1")

    # the stage-1 step: global BatchNorm statistics
    counts = [got["stage1"]["mask_count"] for got in two]
    a, b = r0["stage1"]["info"], one["stage1"]["info"]
    terms = {k: abs(a[k] - b[k]) / max(abs(b[k]), 1e-12) for k in b
             if k.endswith("loss")}
    ds = max(float(((r0["stage1"]["stats"][k] - v).abs()
                    / v.abs().clamp(min=1)).max())
             for k, v in one["stage1"]["stats"].items())
    gl1, gn1 = grad_gap(r0["stage1"]["grads"], one["stage1"]["grads"])
    print(f"[dp] stage-1 step, event masks of {counts} pixels on the "
          f"ranks: loss {a['loss']:.6f} / {b['loss']:.6f}; relative "
          f"differences " + ", ".join(f"{k} {v:.2e}" for k, v in
                                      terms.items())
          + f"; running statistics max diff {ds:.2e} x max(1, |r|) over "
          f"{len(one['stage1']['stats'])} tensors; gradient: largest leaf "
          f"error {gl1:.3e} of the leaf's largest, relative norm {gn1:.3e}")
    require(len(set(counts)) > 1, f"equal mask counts {counts}")
    require(max(terms.values()) <= DP_S1_LOSS_REL and ds <= DP_STAT_TOL
            and gl1 <= DP_S1_GRAD_LEAF and gn1 <= DP_S1_GRAD_NORM,
            "stage-1 world 2 != world 1")

    # the heads split over (1, world): LightGlue's forward in float32 (TF32
    # off) within 1e-3 of the largest value of the whole heads' (float32
    # products summed in another order, compounded through 9 layers and
    # the log-softmaxes); in bfloat16, nine layers of rounding part any two
    # bf16 forwards, so the split is held to bf16's own error instead: the
    # sharded bf16 forward's RMS distance from the float32 forward at most
    # 1.5 times the whole-heads bf16 forward's
    fin = torch.isfinite(one["lightglue32"])
    for key in ("lightglue", "lightglue32"):
        for got in (r0[key], one[key]):
            require(torch.equal(fin, torch.isfinite(got)),
                    "non-finite pattern")
    la32 = one["lightglue32"][fin]
    err32 = float((r0["lightglue32"][fin] - la32).abs().max())
    tol32 = 1e-3 * max(1.0, float(la32.abs().max()))

    def rms(a):
        return float(a.square().mean().sqrt())

    err = float((r0["lightglue"][fin] - one["lightglue"][fin]).abs().max())
    rms_split = rms(r0["lightglue"][fin] - la32)
    rms_whole = rms(one["lightglue"][fin] - la32)
    a, b = r0["shard_stage2"]["info"], one["shard_stage2"]["info"]
    dl = abs(a["loss"] - b["loss"]) / abs(b["loss"])
    dg = abs(a["grad_norm"] - b["grad_norm"]) / abs(b["grad_norm"])
    gl, gn = grad_gap(r0["shard_stage2"]["grads"],
                      one["shard_stage2"]["grads"])
    dp = max(float((r0["shard_stage2"]["state_dict"][k] - v).abs().max())
             for k, v in one["shard_stage2"]["state_dict"].items())
    want_tp = {n: 0 for n in kernel_counters()}
    want_tp.update(nms_rounds=2)
    print(f"[dp] shard_heads over (1, {world}): LightGlue log-assignment "
          f"in float32 max err {err32:.3e} (bound {tol32:.3e}); in bfloat16 "
          f"max err {err:.3e} from the whole heads', RMS from float32 "
          f"{rms_split:.4e} split against {rms_whole:.4e} whole (bound "
          f"1.5x); stage-2 step loss rel {dl:.2e}, grad_norm rel {dg:.2e}, "
          f"gradient: largest leaf error {gl:.3e}, relative norm "
          f"{gn:.3e}; max |param diff| {dp:.2e}; launches a rank "
          f"{r0['shard_stage2']['launches']}; C on its own tensors "
          + json.dumps(r0["shard_stage2"]["path_kernels"]))
    require(err32 <= tol32 and rms_split <= 1.5 * rms_whole,
            "sharded LightGlue forward != whole")
    require(all(got["shard_stage2"]["launches"] == want_tp for got in two),
            "shard_heads step launches")
    require(dl <= DP_LOSS_REL and dg <= DP_GNORM_REL
            and gl <= DP_GRAD_LEAF and gn <= DP_GRAD_NORM
            and dp <= DP_PARAM_LRS * STAGE2_LR, "shard_heads step != whole")

    # BA over the ranks
    e2, e1 = two[0]["ba"], one["ba"]
    dba = float(np.abs(e2 - e1).max())
    print(f"[dp] BA over {world} ranks: cost {e2[0]:.4f} -> {e2[-1]:.4f} "
          f"(one "
          f"process {e1[0]:.4f} -> {e1[-1]:.4f}), max diff {dba:.3e} "
          f"(bound {1e-4 * e1[0]:.3e})")
    require(all(np.array_equal(got["ba"], e2) for got in two),
            "the ranks' BA costs differ")
    require(dba <= 1e-4 * e1[0], f"BA over {world} ranks != 1")

    s2, s1 = r0["stage2"], one["stage2"]
    return {"launches": r0["stage2"]["launches"], "wall_s": wall,
            "path_kernels": {n: max(got["stage2"]["path_kernels"][n][1]
                                    for got in two)
                             for n in r0["stage2"]["path_kernels"]},
            "ms_1": s1["ms"], "ms_2": max(g["stage2"]["ms"] for g in two),
            "collective_ms": s2["collective_ms"],
            "ms_synced": s2["ms_synced"]}


# ---------------------------------------------------------------------------
# phase 15: the SLAM chain on rendered MVSEC, adaptive evaluation, geometry
# ---------------------------------------------------------------------------

# slam_mvsec.py's defaults: 40 keyframes 2 frames apart, 512 keypoints, 12
# LM iterations; indoor_flying1 rendered at 84 frames (shorter than its
# crop, so the reader keeps them all) and read from frame 4, the first
# with a whole 0.4 s event window behind it
SLAM_MVSEC_FRAMES, SLAM_MVSEC_FIRST, SLAM_MVSEC_STRIDE = 84, 4, 2
SLAM_MVSEC_ITERS, SLAM_SHARDED_REL = 12, 1.5e-3
ADAPTIVE_BATCHES, ADAPTIVE_ITERS = 16, 10


class ExactFrontEnd(torch.nn.Module):
    """A stand-in for the stage-1 extractor whose tracks are right by
    construction: `n` points of the rendered scene's plane (z = 3 m, the
    middle 2 x 1.4 m that every frame sees) projected through each frame's
    true pose and K, with `noise_px` of Gaussian pixel noise, a one-hot
    descriptor a point (so MNN matches every point seen twice). The
    chain calls it once a frame, in order. It tests the chain's back end
    (chaining, triangulation, drift, gate, BA, ATE) apart from what the
    weights can find."""

    def __init__(self, frames, n: int = SLAM_TOPK, noise_px: float = 0.5,
                 seed: int = 15, device="cuda"):
        super().__init__()
        from ei_nexus_tpu_torch.models.extractor import \
            KeypointExtractorConfig
        rng = np.random.default_rng(seed)
        X = np.stack([rng.uniform(-1.0, 1.0, n), rng.uniform(-0.7, 0.7, n),
                      np.full(n, 3.0)], -1)
        self.config = KeypointExtractorConfig(detection_top_k=n)
        self.anchor = torch.nn.Parameter(torch.zeros(0, device=device))
        self.views = []
        for fr in frames:
            Xc = X @ fr["pose"][:3, :3].T.astype(np.float64) \
                + fr["pose"][:3, 3]
            uv = Xc @ fr["K"].T.astype(np.float64)
            uv = uv[:, :2] / uv[:, 2:] + rng.normal(0, noise_px, (n, 2))
            valid = ((Xc[:, 2] > 0) & (uv[:, 0] >= 0) & (uv[:, 0] < 346)
                     & (uv[:, 1] >= 0) & (uv[:, 1] < 260))
            pos = np.concatenate([uv[:, ::-1], np.ones((n, 1))], 1)
            self.views.append({
                "sparse_positions": torch.as_tensor(
                    pos[None], dtype=torch.float32, device=device),
                "sparse_descriptors": torch.eye(
                    n, device=device)[None],
                "sparse_valid": torch.as_tensor(valid[None],
                                                device=device)})
        self.calls = 0

    def forward(self, rep, mask):
        out = self.views[self.calls]
        self.calls += 1
        return out


def match_errors(frames, run) -> np.ndarray:
    """Each match of the chain's front end against the truth: the pixel
    distance between the matched keypoint and its partner projected
    through the rendered depth and the true poses."""
    errs = []
    for i, m0 in enumerate(run["matches01"]):
        kp0 = run["keypoints"][i][:, 1::-1].astype(np.float64)   # xy
        kp1 = run["keypoints"][i + 1][:, 1::-1].astype(np.float64)
        K, d = frames[i]["K"].astype(np.float64), frames[i]["depth"]
        T01 = frames[i + 1]["pose"] @ np.linalg.inv(frames[i]["pose"])
        sel = np.nonzero(m0 > -1)[0]
        xy = kp0[sel]
        z = d[np.clip(xy[:, 1].astype(int), 0, d.shape[0] - 1),
              np.clip(xy[:, 0].astype(int), 0, d.shape[1] - 1)]
        X = (np.concatenate([xy, np.ones((len(sel), 1))], 1)
             @ np.linalg.inv(K).T) * z[:, None]
        X1 = X @ T01[:3, :3].T + T01[:3, 3]
        uv = X1 @ K.T
        errs.append(np.linalg.norm(uv[:, :2] / uv[:, 2:] - kp1[m0[sel]],
                                   axis=-1))
    return np.concatenate(errs)


def phase_slam_mvsec(s1_final: str) -> dict:
    """(15a) `slam_mvsec.slam_chain` at full width (260x346, 16 bins, the
    VGG 128/256/256 event extractor, top-k 512, 40 keyframes at stride 2,
    12 LM iterations, the tool's drift, gate and prior) with phase 9's
    stage-1 `final`, on indoor_flying1 rendered in memory by
    `data/mini_mvsec.py` and read through the MVSEC reader's own windows
    (`MVSECSequence.view` over `RenderedArchive`: the card's machine has
    no h5py). Launches read around the chain (C once a keyframe, nothing
    else), C held bit-exact on the first map the chain hands it, the
    robust cost and the reprojection median lower after BA; each match
    measured against the rendered depth and poses; the ATE before and
    after BA printed. Then the same chain with `ExactFrontEnd` (tracks
    right to 0.5 px): the ATE lower after BA than before; and
    `--check-sharded`'s solve of that problem over 2 gloo ranks on the
    card, its final cost within SLAM_SHARDED_REL of one process's. Phase
    9's few steps leave the extractor's matches pixels off the truth,
    which BA fits without bringing the trajectory closer to it, and the
    Cauchy loss on such tracks has a flat valley of nearby optima that
    float32 sums in another order reach apart (PERF.md §6): the ATE's
    fall and the ranks' agreement are required of the back end on tracks
    that allow them. Returns the numbers."""
    from ei_nexus_tpu_torch import slam_mvsec as sm
    from ei_nexus_tpu_torch.data import mini_mvsec
    from ei_nexus_tpu_torch.data.mvsec import MVSECSequence
    from ei_nexus_tpu_torch.ops import detector

    t = time.perf_counter()
    arrays = mini_mvsec.render_sequence(SLAM_MVSEC_FRAMES, 0.0, 10)
    seq = MVSECSequence(mini_mvsec.RenderedArchive(
        {"indoor_flying1": arrays}), "indoor_flying1")
    frames = [seq.view(SLAM_MVSEC_FIRST + SLAM_MVSEC_STRIDE * i,
                       sm.EVENT_DT, sm.MAX_EVENTS) for i in range(SLAM_KF)]
    render_s = time.perf_counter() - t
    events = [int(f["events_valid"].sum()) for f in frames]
    print(f"[slam-mvsec] indoor_flying1 rendered ({SLAM_MVSEC_FRAMES} "
          f"frames, {len(arrays['events'])} events) and read through the "
          f"MVSEC reader in {render_s:.1f} s; {SLAM_KF} keyframes of "
          f"{min(events)}-{max(events)} events")
    extractor = sm.stage1_extractor(s1_final, SLAM_TOPK, "cuda")
    sm.slam_chain(frames[:3], extractor, iters=1)           # warm
    counters = kernel_counters()
    for c in counters.values():
        c.launches = 0
    out = {}

    def chain():
        out["metrics"], out["run"] = sm.slam_chain(
            frames, extractor, iters=SLAM_MVSEC_ITERS)

    seen = record_kernel_inputs(chain, ((detector, "nms_rounds"),))
    launches = {n: c.launches for n, c in counters.items()}
    want = {n: 0 for n in counters}
    want["nms_rounds"] = SLAM_KF
    require(launches == want, f"[slam-mvsec] launches {launches} != {want}")
    with torch.no_grad():
        held = _hold_path_kernels(seen)
    require("nms_rounds" in held, "the chain handed C no map")
    m, run = out["metrics"], out["run"]

    def ate(run):
        return tuple(sm.umeyama_ate(sm.centers_from_poses6(
            p.poses.cpu().numpy()), run["gt_centers"])
            for p in (run["problem"], run["refined"]))

    ate0, ate1 = ate(run)
    errs = match_errors(frames, run)
    within = {px: float((errs < px).mean()) for px in (1, 3)}
    extract_ms = 1e3 * run["extract_seconds"] / SLAM_KF
    rep0, rep1 = (m["reproj_median_px_and_frac3px_before"],
                  m["reproj_median_px_and_frac3px_after"])
    print(f"[slam-mvsec] C {launches['nms_rounds']} launches for {SLAM_KF} "
          f"keyframes, held bit-exact at {held.get('nms_rounds')}; "
          f"{m['mnn_matches_per_pair']} MNN matches a pair ({len(errs)} in "
          f"all: {100 * within[1]:.1f}% within 1 px of the truth, "
          f"{100 * within[3]:.1f}% within 3 px, median "
          f"{np.median(errs):.2f} px), {run['tracks']} tracks -> "
          f"{m['landmarks']} landmarks, {m['observations']} observations; "
          f"robust cost by iteration {m['robust_cost']}; reprojection "
          f"median px and share < 3 px {rep0} -> {rep1}; ATE {ate0:.5f} -> "
          f"{ate1:.5f} m; extract {extract_ms:.3f} ms a frame; BA "
          f"{m['ba_seconds']} s")
    require(np.isfinite(run["costs"]).all()
            and run["costs"][-1] < run["costs"][0],
            f"BA's robust cost did not fall: {run['costs']}")
    require(rep1[0] < rep0[0], f"the reprojection median rose {rep0} -> "
                               f"{rep1}")
    em, erun = sm.slam_chain(frames, ExactFrontEnd(frames),
                             iters=SLAM_MVSEC_ITERS)
    exact = ate(erun)
    print(f"[slam-mvsec] the same chain on exact tracks (0.5 px noise): "
          f"{em['landmarks']} landmarks, {em['observations']} "
          f"observations, robust cost {em['robust_cost'][0]} -> "
          f"{em['robust_cost'][-1]}, ATE {exact[0]:.5f} -> {exact[1]:.5f} m")
    require(exact[1] < exact[0], f"BA on exact tracks left the ATE at "
                                 f"{exact[1]} >= {exact[0]}")
    t = time.perf_counter()
    sharded = sm.check_sharded(erun)
    sharded_s = time.perf_counter() - t
    single, split = sharded["final_cost_single"], \
        sharded["final_cost_sharded"]
    gap = abs(split - single) / abs(single)
    print(f"[slam-mvsec] --check-sharded over 2 gloo ranks on the card, on "
          f"the exact tracks' problem: {json.dumps(sharded)}, relative gap "
          f"{gap:.2e} (bound {SLAM_SHARDED_REL:.1e}), {sharded_s:.1f} s")
    require(gap <= SLAM_SHARDED_REL, f"sharded BA {split} != {single}")
    return {"launches": launches, "metrics": m, "ate": (ate0, ate1),
            "exact_ate": exact, "within": within,
            "extract_ms": extract_ms, "render_s": render_s,
            "sharded": sharded, "held": held}


def phase_eval_adaptive(data: str, s2_final: str) -> dict:
    """(15b) `python -m ei_nexus_tpu_torch.eval_adaptive`'s path (its
    `main`, in this process) over phase 11's mini-EC with phase 11's
    stage-2 `final`: the RPE protocol at B=1 over ADAPTIVE_BATCHES pairs,
    base then adaptive (depth 0.95, width 0.99), then the B=8 timing
    (ADAPTIVE_ITERS forwards, CUDA events). Launches read around one
    forward of each model, the adaptive one's held to its exit layer (A
    2 (e + 1), B e + 1, C 2); A, B and C held against their plain versions
    on the tensors the adaptive forward hands them; with depth and width
    -1 the "adaptive" forward equal to the base one bit for bit
    (deterministic algorithms, one voxel grid for both)."""
    from ei_nexus_tpu_torch import eval_adaptive as ea
    from ei_nexus_tpu_torch.data import DataLoader
    from ei_nexus_tpu_torch.models import lightglue
    from ei_nexus_tpu_torch.ops import detector
    from ei_nexus_tpu_torch.train.evaluate import val_dataset
    from ei_nexus_tpu_torch.train.steps import batch_representation
    from ei_nexus_tpu_torch.utils import load_config

    overrides = ["dataset=test_ec", f"dataset.data_path={data}"]
    t = time.perf_counter()
    result = ea.main(["--config", STAGE2_CONFIG, "--ckpt", s2_final,
                      "--max-batches", str(ADAPTIVE_BATCHES), "--iters",
                      str(ADAPTIVE_ITERS), "--device", "cuda"] + overrides)
    wall = time.perf_counter() - t
    require(sum(result["exit_layer_hist"]) == ADAPTIVE_BATCHES,
            f"exit histogram {result['exit_layer_hist']}")
    for part in ("base", "adaptive"):
        aucs = [result[part][f"auc@{t}"] for t in (5, 10, 20)]
        require(all(np.isfinite(aucs)), f"{part} AUCs {aucs}")

    cfg = load_config(STAGE2_CONFIG, overrides)
    ds = cfg.dataset.to_dict()
    (H, W), bins, rep = ds["resolution"], ds["channel"], \
        ds["representation_type"]
    ad_cfg = load_config(STAGE2_CONFIG, overrides + [
        "model.matcher.LightGlue.depth_confidence=0.95",
        "model.matcher.LightGlue.width_confidence=0.99"])
    model, model_ad = ea.build_models(cfg, ad_cfg, s2_final, "cuda")
    data0, data1 = next(iter(DataLoader(val_dataset(ds), batch_size=1)))[:2]
    counters = kernel_counters()
    with torch.no_grad():
        ev_rep, ev_mask = batch_representation(data0, rep, bins, H, W,
                                               device="cuda")
        image = torch.as_tensor(data1["image"]).cuda()
        launches = {}
        for name, net in (("base", model), ("adaptive", model_ad)):
            for c in counters.values():
                c.launches = 0
            out = net(ev_rep, image, ev_mask)[2]
            torch.cuda.synchronize()
            launches[name] = {n: c.launches for n, c in counters.items()}
        e = int(out["exit_layer"])
        L = model.config.matcher.lightglue.n_layers
        for name, layers in (("base", L), ("adaptive", e + 1)):
            want = {n: 0 for n in counters}
            want.update(self_attention_rot=2 * layers,
                        cross_attention_bidir=layers, nms_rounds=2)
            require(launches[name] == want,
                    f"[eval-adaptive] {name} launches {launches[name]} != "
                    f"{want}")
        seen = record_kernel_inputs(
            lambda: model_ad(ev_rep, image, ev_mask),
            ((lightglue, "self_attention"),
             (lightglue, "cross_attention_bidir"),
             (detector, "nms_rounds")))
        held = _hold_path_kernels(seen)
        require(set(held) == {"self_attention_rot", "cross_attention_bidir",
                              "nms_rounds"},
                f"[eval-adaptive] held {sorted(held)}")
        off_cfg = load_config(STAGE2_CONFIG, overrides + [
            "model.matcher.LightGlue.depth_confidence=-1",
            "model.matcher.LightGlue.width_confidence=-1"])
        _, model_off = ea.build_models(cfg, off_cfg, s2_final, "cuda")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            want = model(ev_rep, image, ev_mask)[2]
            got = model_off(ev_rep, image, ev_mask)[2]
        finally:
            torch.use_deterministic_algorithms(False)
    require(sorted(got) == sorted(want) and "exit_layer" not in got,
            "adaptive off: the outputs' keys differ from the base's")
    for k, v in want.items():
        if torch.is_tensor(v):
            require(torch.equal(got[k], v), f"adaptive off: {k} != base's")
    print(f"[eval-adaptive] {ADAPTIVE_BATCHES} pairs of EC's test protocol, "
          f"phase 11's stage-2 checkpoint: exit histogram "
          f"{result['exit_layer_hist']} (mean {result['exit_layer_mean']}); "
          f"base {json.dumps(result['base'])}; adaptive "
          f"{json.dumps(result['adaptive'])}; a batch of 8: "
          f"{result['ms_per_batch8_base']} ms base, "
          f"{result['ms_per_batch8_adaptive']} ms adaptive, speed-up "
          f"{result['speedup']}; {wall:.1f} s")
    print(f"[eval-adaptive] launches a forward: base {launches['base']}, "
          f"adaptive (exit after layer {e}) {launches['adaptive']}; "
          f"against the plain versions on the adaptive forward's tensors "
          f"(shape, max|err|): {json.dumps(held)}; depth and width -1: "
          f"equal to the base forward bit for bit")
    return {"result": result, "launches": launches, "held": held,
            "exit_layer": e}


def phase_geometry() -> None:
    """(15c) The geometry and detector functions this slice ported, on
    CUDA tensors against the CPU, float32: values to 1e-5 relative (with
    an absolute floor of 1e-5 of the largest value where a value cancels
    larger terms), angles to 1e-3 degree (rotations ~0.5 rad and vectors
    apart, where float32's arccos is well conditioned; near 0 and 180
    degrees the CPU tests hold them in float64), masks and `as_4x4mat`
    exactly, E's decomposition as a set (each device's SVD signs are its
    own)."""
    from ei_nexus_tpu_torch.geometry import Camera, Pose
    from ei_nexus_tpu_torch.geometry import depthproj, epipolar as ep
    from ei_nexus_tpu_torch.geometry.se3 import so3exp_map
    from ei_nexus_tpu_torch.ops import space_to_depth

    g = torch.Generator().manual_seed(15)
    B, N = 4, 64
    wh = torch.tensor([346.0, 260.0])
    x = {"R": so3exp_map(0.3 * torch.randn(B, 3, generator=g)),
         "t": torch.randn(B, 3, generator=g) + 0.5,
         "K": torch.tensor([[199.0, 0, 173.0], [0, 199.0, 130.0],
                            [0, 0, 1.0]]).expand(B, 3, 3),
         "p0": torch.rand(B, N, 2, generator=g) * wh,
         "p1": torch.rand(B, N, 2, generator=g) * wh,
         "depth": 3.0 + torch.rand(2, B, 26, 34, generator=g),
         "R_s": so3exp_map(0.05 * torch.randn(B, 3, generator=g)),
         "t_s": 0.05 * torch.randn(B, 3, generator=g),
         "dR": so3exp_map(0.3 * torch.randn(B, 3, generator=g)),
         "t2": torch.randn(B, 3, generator=g),
         "score": torch.rand(2, 24, 32, generator=g) / 32}
    x["depth"][torch.rand(x["depth"].shape, generator=g) < 0.1] = 0.0
    x["K_s"] = x["K"] * torch.tensor([0.1, 0.1, 1.0])[:, None]

    def run(dev):
        v = {k: t.to(dev) for k, t in x.items()}
        T = Pose.from_Rt(v["R"], v["t"])
        cam = Camera.from_calibration_matrix(v["K"], wh.to(dev))
        cam_s = Camera.from_calibration_matrix(v["K_s"], (wh / 10).to(dev))
        E = ep.T_to_E(T)
        F = ep.T_to_F(cam, cam, T)
        out = {"E_to_F": ep.E_to_F(cam, cam, E), "T_to_F": F,
               "F_to_E": ep.F_to_E(cam, cam, F),
               "sym_sq": ep.sym_epipolar_distance(v["p0"], v["p1"], F),
               "sym": ep.sym_epipolar_distance(v["p0"], v["p1"], F, False)}
        for ess in (True, False):
            for allp in (True, False):
                out[f"epi_{ess}_{allp}"] = ep.generalized_epi_dist(
                    v["p0"], v["p1"], cam, cam, T, allp, ess)
        out["warp"], out["warp_valid"] = depthproj.dense_warp_consistency(
            v["depth"][0], v["depth"][1], Pose.from_Rt(v["R_s"], v["t_s"]),
            cam_s, cam_s, ccth=4.0)
        out["s2d"] = space_to_depth(v["score"], 8)
        out["mat"] = T.as_4x4mat()
        R2 = T.R @ v["dR"]
        out["ang_mat"] = ep.angle_error_mat(T.R, R2)
        out["ang_vec"] = ep.angle_error_vec(T.t, v["t2"])
        out["rpe"] = torch.stack(ep.relative_pose_error(T, R2, v["t2"]))
        out["decomp"] = ep.decompose_essential_matrix(E)
        return out

    cpu = run("cpu")
    valid = cpu["warp_valid"]
    require(0 < int(valid.sum()) < valid.numel(), "a trivial warp mask")
    gpu = {k: tuple(t.cpu() for t in v) if isinstance(v, tuple)
           else v.cpu() for k, v in run("cuda").items()}
    worst = {}
    for k, want in cpu.items():
        got = gpu[k]
        if k == "decomp":
            for b in range(B):
                pairs = [(got[0][b], want[0][b]), (got[1][b], want[1][b])]
                crossed = [(got[0][b], want[1][b]), (got[1][b], want[0][b])]
                e_r = min(max(max_err(a, c) for a, c in pairs),
                          max(max_err(a, c) for a, c in crossed))
                e_t = min(max_err(got[2][b], want[2][b]),
                          max_err(got[2][b], -want[2][b]))
                require(e_r <= 1e-5 and e_t <= 1e-5,
                        f"decompose_essential_matrix: R {e_r:.2e}, t {e_t:.2e}")
                worst[k] = max(worst.get(k, 0.0), e_r, e_t)
        elif k in ("warp_valid", "mat"):
            require(torch.equal(got, want), f"{k} differs")
            worst[k] = 0.0
        elif k.startswith(("ang", "rpe")):
            e = max_err(got, want)
            require(e <= 1e-3, f"{k}: {e:.2e} degree")
            worst[k] = e
        elif k == "s2d":
            require(torch.equal(got[..., :-1], want[..., :-1])
                    and max_err(got[..., -1], want[..., -1]) <= 1e-6,
                    "space_to_depth differs")
            worst[k] = max_err(got, want)
        else:
            floor = 1e-5 * float(want.abs().max())
            bad = ((got - want).abs() > 1e-5 * want.abs() + floor).sum()
            require(int(bad) == 0, f"{k}: {int(bad)} values beyond 1e-5")
            worst[k] = max_err(got, want)
    print("[geometry] the new functions on the card against the CPU, max "
          "abs err: " + json.dumps({k: float(f"{v:.3g}")
                                    for k, v in worst.items()}))


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
        entry_rate, entry_walls, s1_final = timed("stage-1 entry point",
                                                  phase_entry, data, tmp)
        # phase 10: the SiLK family
        silk_launches, silk_ms, silk_peak = timed(
            "SiLK forwards", phase_silk_forwards, fwd_ms)
        c_row = next(r for r in rows if r["name"] == "nms_rounds")
        c_row.update(timed("kernel C at the cell-1 shapes", phase_nms_cell1,
                           torch.Generator(device="cuda").manual_seed(3)))
        timed("cpu vs card, SiLK forwards", phase_silk_cpu_vs_gpu)
        silk_s2_launches, silk_step_ms, silk_s2_peak = timed(
            "SiLK stage-2 step", phase_silk_stage2)
        silk_entry_rate, silk_entry_walls, _ = timed(
            "SiLK stage-1 entry point", phase_entry, data, tmp,
            "silk-entry", SILK_ENTRY_CONFIG, False)
        # phase 11: homography-supervised stage 2, its entry, evaluation
        t11 = time.perf_counter()
        h_launches, h_ms, h_peak = timed(
            "homography step", phase_stage2, "homography", None, True)
        timed("cpu vs card, homography step", phase_homography_cpu_vs_gpu)
        val_render_s = timed("mini-EC render (validation)",
                             render_mini_ec_val, data)
        m_rate, m_walls, s2_final = timed(
            "stage-2 entry point", phase_entry, data, tmp, "matcher-entry",
            STAGE2_CONFIG, True, "train_matcher",
            ["--stage1-ckpt", s1_final], ["dataset=ec"],
            ("homography-supervised stage 2", "grid 180x240",
             "loaded stage-1 event extractor"))
        eval_walls = timed("evaluation entry points", phase_eval_entries,
                           data, s2_final, s1_final)
        eval_launches, eval_rates, cv2_share = timed(
            "evaluation loop", phase_eval_loop, data, s2_final)
        walls["phase 11"] = time.perf_counter() - t11
        print(f"[wall] phase 11: {walls['phase 11']:.1f} s")
        # phase 12a: reference .pth checkpoints (over phase 11's mini-EC)
        pth_launches, pth_walls = timed("reference .pth", phase_pth, data,
                                        tmp)
        # phase 14a: the stage-2 entry under torchrun, NCCL
        dp_entry = timed("data-parallel entry (NCCL)", phase_dp_entry, data,
                         tmp, s1_final)
        # phase 15: the SLAM chain on rendered MVSEC (phase 9's stage-1
        # checkpoint), adaptive evaluation (phase 11's mini-EC and stage-2
        # checkpoint), the new geometry functions
        t15 = time.perf_counter()
        slam15 = timed("SLAM on rendered MVSEC", phase_slam_mvsec, s1_final)
        adaptive15 = timed("adaptive evaluation", phase_eval_adaptive, data,
                           s2_final)
        timed("geometry on the card", phase_geometry)
        walls["phase 15"] = time.perf_counter() - t15
        print(f"[wall] phase 15: {walls['phase 15']:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rep_ms = timed("representations", phase_representations)
    # phase 12b: adaptive LightGlue; phase 13: the SLAM back end
    adaptive_launches, adaptive_rows = timed("adaptive LightGlue",
                                             phase_adaptive, fwd_ms)
    ba = timed("bundle adjustment", phase_ba)
    timed("cpu vs card, BA and pose graph", phase_ba_cpu_vs_gpu)
    slam = timed("SLAM assembly", phase_slam)
    # phase 14b: 2 gloo ranks on the card against one process
    dp = timed("multi-process (gloo, 2 ranks)", phase_dp)
    for r in rows:
        r["launches_silk_lg_forward"] = silk_launches[r["name"]]
        r["launches_silk_stage2_step"] = silk_s2_launches[r["name"]]
        r["launches_homography_step"] = h_launches[r["name"]]
        r["launches_eval_forward"] = eval_launches[r["name"]]
        r["launches_pth_eval_forward"] = pth_launches[r["name"]]
        r["launches_adaptive_forward"] = {
            k: v[r["name"]] for k, v in adaptive_launches.items()}
        r["launches_dp_stage2_step_per_rank"] = dp["launches"][r["name"]]
        if r["name"] in dp["path_kernels"]:
            # the largest error over the ranks, each on its own tensors
            r["max_abs_err_dp_rank"] = dp["path_kernels"][r["name"]]
        r["launches_slam_mvsec_front_end"] = slam15["launches"][r["name"]]
        r["launches_eval_adaptive_forward"] = {
            k: v[r["name"]] for k, v in adaptive15["launches"].items()}
        if r["name"] in adaptive15["held"]:
            r["max_abs_err_eval_adaptive"] = \
                adaptive15["held"][r["name"]][1]

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
    print(f"homography stage-2 step: {1e3 / h_ms:.3f} steps/s ({h_ms:.3f} "
          f"ms per step of {B} pairs, back to back; peak {h_peak:.2f} GB), "
          f"{step_ms / h_ms:.3f}x the pose + depth step's {1e3 / step_ms:.3f} "
          f"steps/s in this run, on {smi}")
    print(f"stage-2 entry point (configs/train_EIM_stage2.yaml dataset=ec, "
          f"the homography route, B={B}, 180x240 grid, from phase 9's "
          f"stage-1 checkpoint): steady {m_rate:.3f} steps/s (steps 3-4); "
          f"process wall {m_walls[0]:.1f} s for 4 steps, {m_walls[1]:.1f} s "
          f"resumed for 2, on {smi}")
    print(f"evaluation (EC test protocol, B=1, 180x240, validation "
          f"sequences rendered in {val_render_s:.1f} s): rpe_eval "
          f"{eval_rates['opencv']:.2f} pairs/s with OpenCV "
          f"({100 * cv2_share:.1f}% of the loop in cv2's pose estimation), "
          f"{eval_rates['torch']:.2f} pairs/s with the torch backend; entry "
          f"process walls "
          + json.dumps({k: round(v, 1) for k, v in eval_walls.items()})
          + f" s, on {smi}")
    print("representations on the card, ms a batch of 8 (131,072 slots, 16 "
          "bins, 260x346, with the accumulation mask): "
          + json.dumps({k: round(v, 4) for k, v in rep_ms.items()})
          + f", on {smi}")
    print(f"reference .pth (flagship of {STAGE2_CONFIG}): the eval entry "
          f"and train_extractor superpoint_weights=, process walls "
          + json.dumps({k: round(v, 1) for k, v in pth_walls.items()})
          + f" s, on {smi}")
    print("adaptive LightGlue (flagship, bf16, B=8, depth 0.95 / width "
          "0.99 or width alone for the pruning regimes), by setting/"
          "regime: " + json.dumps(
              {k: {n: (round(v, 4) if isinstance(v, float) else v)
                   for n, v in row.items()}
               for k, row in adaptive_rows.items()}) + f", on {smi}")
    print(f"bundle adjustment ({BA_KF} keyframes, {BA_LM} landmarks, "
          f"{ba['observations']} observations, {BA_CG} CG steps, Huber "
          f"{BA_HUBER}, z_min {BA_ZMIN}): {ba['ms_per_iter']:.3f} ms per LM "
          f"iteration ({ba['busy_ms_one_iter']:.3f} ms of the card's time in "
          f"a solve of one), {ba['ms_total']:.1f} ms for {BA_ITERS}, cost "
          f"{ba['cost'][0]:.4f} -> {ba['cost'][1]:.4f}, {ba['syncs']} host "
          f"syncs, peak {ba['peak_gb']:.2f} GB, on {smi}")
    print(f"refine_map ({SLAM_KF} keyframes x {SLAM_TOPK} keypoints, "
          f"{slam['tracks']} tracks): cost {slam['cost'][0]:.4f} -> "
          f"{slam['cost'][1]:.4f}, ATE {slam['ate'][0]:.4f} -> "
          f"{slam['ate'][1]:.4f}, {slam['wall_s']:.2f} s; front end "
          f"{slam['front_end_tracks']} tracks, on {smi}")
    print(f"data-parallel stage-2 step (flagship, global batch {B}): "
          f"{1e3 / dp['ms_1']:.3f} steps/s in one process ({dp['ms_1']:.3f} "
          f"ms), {1e3 / dp['ms_2']:.3f} steps/s over 2 gloo ranks on this one "
          f"card ({dp['ms_2']:.3f} ms; 4 rows a rank); collectives "
          f"{dp['collective_ms']:.3f} ms of a {dp['ms_synced']:.3f} ms step "
          f"with the card synchronised around them "
          f"({100 * dp['collective_ms'] / dp['ms_synced']:.1f}%); not a "
          f"scaling figure: the two ranks share the card's SMs and gloo "
          f"stages every all-reduce through the host; on {smi}")
    print(f"data-parallel entry: torchrun over {dp_entry['ranks']} NCCL "
          f"rank(s), 4 steps in {dp_entry['wall_s']:.1f} s (process wall), "
          f"on {smi}")
    m15, res15 = slam15["metrics"], adaptive15["result"]
    print(f"SLAM on rendered MVSEC (indoor_flying1, {SLAM_KF} keyframes at "
          f"stride {SLAM_MVSEC_STRIDE}, top-k {SLAM_TOPK}, phase 9's "
          f"stage-1 checkpoint): C {slam15['launches']['nms_rounds']} "
          f"launches, extract {slam15['extract_ms']:.3f} ms a frame, "
          f"{m15['mnn_matches_per_pair']} matches a pair, "
          f"{m15['landmarks']} landmarks / {m15['observations']} "
          f"observations, robust cost {m15['robust_cost'][0]} -> "
          f"{m15['robust_cost'][-1]} in {SLAM_MVSEC_ITERS} LM iterations, "
          f"BA {m15['ba_seconds']} s, ATE {slam15['ate'][0]:.5f} -> "
          f"{slam15['ate'][1]:.5f} m ({100 * slam15['within'][1]:.1f}% of "
          f"the matches within 1 px of the truth; on exact tracks "
          f"{slam15['exact_ate'][0]:.5f} -> {slam15['exact_ate'][1]:.5f} "
          f"m); sharded over 2 gloo ranks (exact tracks) "
          f"{slam15['sharded']['final_cost_sharded']} against "
          f"{slam15['sharded']['final_cost_single']}, on {smi}")
    print(f"adaptive evaluation (EC test protocol, {ADAPTIVE_BATCHES} pairs, "
          f"phase 11's stage-2 checkpoint): exit histogram "
          f"{res15['exit_layer_hist']}, AUC@5/10/20 base "
          f"{[res15['base'][f'auc@{t}'] for t in (5, 10, 20)]} adaptive "
          f"{[res15['adaptive'][f'auc@{t}'] for t in (5, 10, 20)]}; a batch "
          f"of 8: {res15['ms_per_batch8_base']} ms base, "
          f"{res15['ms_per_batch8_adaptive']} ms adaptive (speed-up "
          f"{res15['speedup']}), on {smi}")
    print(f"wall seconds by phase: {json.dumps(walls)}")
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
