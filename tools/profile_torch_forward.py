#!/usr/bin/env python
"""Where the time of the port's flagship forward, or of its stage-2
training step, goes on one GPU.

    python tools/profile_torch_forward.py [--path forward|stage2]
        [--attention auto|flash|qblock] [--pose] [--seed 0] [--iters 3]
        [--no-trace]

Builds the full-width flagship EIM of `ei_nexus_tpu_torch` (bf16, B=8,
random weights from --seed) on bursty events. `--path forward` (default)
voxelizes on the card and runs the inference forward, with LightGlue's
attention as --attention gives it: "auto" (kernels A and B), "flash"
(kernel G) or "qblock" ("auto" with block_q=64: kernel E); with --pose
the forward is chained with the 5-point RANSAC pose tail as chip_smoke.py's
serving phase chains it, and the pose tail alone (on one forward's
matches) is traced as well. `--path stage2` runs the stage-2 training step
(both extractors frozen, LightGlue trained with AdamW; the same batch and
random slot fill every step). After a warm-up it traces --iters runs with
torch.profiler and prints the device time by kernel group (the port's
kernels A-G, the pose tail's QR, SVD and sampling, convolutions, matrix
products, norms, voxel scatter, sorting, the optimizer, everything else),
the device's busy and idle share of the traced wall time, and the 25
heaviest kernels; unless --no-trace, writes the chrome trace to
chiprun_out/profile_torch_<what>.json. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

# kernel-name fragment -> group, first match wins
GROUPS = (
    ("self_attention_kernel", "A self_attention_rot"),
    ("cross_attention_kernel", "B cross_attention_bidir"),
    ("nms_kernel", "C nms_rounds"),
    ("attention_fwd_kernel", "D attention_fwd"),
    ("qblock_attention_kernel", "E qblock_attention"),
    ("flash_segment_kernel", "G flash_attention"),
    ("bwd_mma_kernel", "F attention_bwd"),
    ("bwd_rows_kernel", "F attention_bwd"),
    ("row_dot_kernel", "F attention_bwd"),
    ("multi_tensor_apply", "optimizer (AdamW, foreach)"),
    ("geqrf", "pose: QR and SVD (cuSOLVER, cuBLAS)"),
    ("orgqr", "pose: QR and SVD (cuSOLVER, cuBLAS)"),
    ("larf", "pose: QR and SVD (cuSOLVER, cuBLAS)"),
    ("gesvd", "pose: QR and SVD (cuSOLVER, cuBLAS)"),
    ("svd", "pose: QR and SVD (cuSOLVER, cuBLAS)"),
    ("cusolver", "pose: QR and SVD (cuSOLVER, cuBLAS)"),
    ("multinomial", "pose: sampling"),
    ("indexFunc", "voxel scatter (index_add_)"),
    ("sort", "top-k sort"),
    ("Sort", "top-k sort"),
    ("fprop", "convolutions (cuDNN)"),
    ("conv", "convolutions (cuDNN)"),
    ("nvjet", "matmuls (cuBLAS)"),
    ("gemm", "matmuls (cuBLAS)"),
    ("nchwToNhwc", "layout copies"),
    ("nhwcToNchw", "layout copies"),
    ("copy", "copies and casts"),
    ("max_pool", "pooling"),
    ("softmax", "softmax"),
    ("SoftMax", "softmax"),
    ("layer_norm", "layer and batch norms"),
    ("batch_norm", "layer and batch norms"),
    ("reduce", "reductions"),
    ("elementwise", "elementwise"),
)


ANNOTATION = re.compile(r"[\w.]+#[\w.]+")


def group_of(name: str) -> str:
    for frag, group in GROUPS:
        if frag in name:
            return group
    return "other"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--path", choices=("forward", "stage2"),
                    default="forward")
    ap.add_argument("--attention", choices=("auto", "flash", "qblock"),
                    default="auto")
    ap.add_argument("--pose", action="store_true")
    ap.add_argument("--no-trace", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_forward: no CUDA device", file=sys.stderr)
        return 2
    B = 8
    if args.path == "stage2":
        runs = {"step": stage2_runner(B, args.seed)}
    else:
        runs = forward_runners(B, args.seed, args.attention, args.pose)
    for what, run in runs.items():
        profile_run(what, run, B, args)
    return 0


def profile_run(what: str, run, B: int, args) -> None:
    """Trace --iters calls of `run` after a warm-up and print where the
    device time goes."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.iters):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    # device-side events, without the ranges the profiler annotates on the
    # device timeline ("Optimizer.step#AdamW.step"), which overlap the
    # kernels they enclose (kernel names may hold "#" too: "{lambda()#3}")
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not ANNOTATION.fullmatch(e.name)]
    by_name, by_group = {}, {}
    for e in kernels:
        us = e.device_time if hasattr(e, "device_time") else e.cuda_time
        by_name[e.name] = by_name.get(e.name, 0.0) + us
        g = group_of(e.name)
        by_group[g] = by_group.get(g, 0.0) + us
    busy_ms = sum(by_name.values()) / 1e3
    per = args.iters
    print(f"{torch.cuda.get_device_name(0)}: {per} traced runs of {what} "
          f"(B={B}), wall {wall_ms / per:.3f} ms each (host clock, traced), "
          f"device busy {busy_ms / per:.3f} ms each, idle share "
          f"{1 - busy_ms / wall_ms:.3f}")
    print(f"device time per {what} by group:")
    for g, us in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"  {us / 1e3 / per:9.3f} ms  {100 * us / 1e3 / busy_ms:5.1f}%"
              f"  {g}")
    print(f"heaviest kernels per {what}:")
    for n, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:25]:
        print(f"  {us / 1e3 / per:9.3f} ms  {n[:110]}")
    if not args.no_trace:
        os.makedirs("chiprun_out", exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            "chiprun_out",
            f"profile_torch_{re.sub(r'[^a-z0-9]+', '_', what).strip('_')}"
            ".json"))
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "batch": B, "run": what,
        "traced_wall_ms": wall_ms / per, "device_busy_ms": busy_ms / per,
        "idle_share": 1 - busy_ms / wall_ms,
        "groups_ms": {g: us / 1e3 / per for g, us in by_group.items()}}))


def forward_runners(B: int, seed: int, attention: str, pose: bool):
    """{name: run}: one inference forward of the flagship (voxel grid
    included) with the given attention setting; with `pose`, the forward
    chained with the pose tail, and the pose tail alone on one forward's
    matches."""
    from ei_nexus_tpu_torch.data.synth import bursty_event_batch
    from ei_nexus_tpu_torch.flagship import build_flagship
    from ei_nexus_tpu_torch.metrics.ransac import estimate_pose_batch
    from ei_nexus_tpu_torch.train.steps import batch_representation

    max_events = 1 << 17
    model, (H, W, bins) = build_flagship(
        dtype="bfloat16", generator=torch.Generator().manual_seed(seed),
        attention_impl="flash" if attention == "flash" else "auto",
        block_q=64 if attention == "qblock" else 0)
    rng = np.random.default_rng(seed)
    ev = bursty_event_batch(rng, B, int(max_events * 0.95), max_events, H, W)
    ev = {k: torch.as_tensor(v).cuda() for k, v in ev.items()}
    image = torch.as_tensor(
        rng.uniform(0, 255, (B, H, W, 1)).astype(np.float32)).cuda()

    @torch.inference_mode()
    def forward():
        rep, mask = batch_representation(ev, "VoxelGrid", bins, H, W)
        return model(rep, image, mask)

    name = f"forward ({attention})"
    if not pose:
        return {name: forward}
    # as bench.py:239-258: focal 199, centre (W/2, H/2), threshold 1/199
    cc = torch.tensor([W / 2.0, H / 2.0], device="cuda")
    thr = torch.full((B,), 1.0 / 199.0, device="cuda")
    gen = torch.Generator(device="cuda")

    @torch.inference_mode()
    def pose_of(out):
        f0, f1, m = out
        m0 = m["matches0"].long()
        idx = m0.clamp(0, m0.shape[-1] - 1)[..., None].expand(-1, -1, 2)
        p0 = m["input_feats0"]["sparse_positions"][..., :2].flip(-1)
        p1 = torch.gather(m["input_feats1"]["sparse_positions"][..., :2]
                          .flip(-1), 1, idx)
        gen.manual_seed(seed)
        return estimate_pose_batch(((p0 - cc) / 199.0).float(),
                                   ((p1 - cc) / 199.0).float(), m0 > -1,
                                   thr, generator=gen)
    out = forward()
    return {f"{name} + pose": lambda: pose_of(forward()),
            "pose tail": lambda: pose_of(out)}


def stage2_runner(B: int, seed: int):
    """One stage-2 training step of the flagship, the same batch and slot
    fill every time (as chip_smoke.py's stage-2 phase)."""
    from ei_nexus_tpu_torch.data.synth import stage2_batch
    from ei_nexus_tpu_torch.flagship import (build_stage2_flagship,
                                             stage2_train_state)
    from ei_nexus_tpu_torch.train.steps import make_stage2_train_step

    max_events = 1 << 17
    model, (H, W, bins) = build_stage2_flagship(
        dtype="bfloat16", generator=torch.Generator().manual_seed(seed))
    state = stage2_train_state(model, steps_per_epoch=100)
    d0, d1, T01, T10 = stage2_batch(np.random.default_rng(seed), B,
                                    int(max_events * 0.95), max_events, H, W)
    batch = ({k: torch.as_tensor(v).cuda() for k, v in d0.items()},
             {k: torch.as_tensor(v).cuda() for k, v in d1.items()},
             torch.as_tensor(T01).cuda(), torch.as_tensor(T10).cuda())
    step = make_stage2_train_step("VoxelGrid", bins, H, W)
    fill = torch.Generator(device="cuda")

    def run():
        fill.manual_seed(seed + 1)
        return step(state, batch, fill)
    return run


if __name__ == "__main__":
    sys.exit(main())
