#!/usr/bin/env python
"""Where the time of the port's flagship forward, or of its stage-1 or
stage-2 training step, goes on one GPU.

    python tools/profile_torch_forward.py [--path forward|stage1|stage2]
        [--attention auto|flash|qblock] [--pose] [--seed 0] [--iters 3]
        [--model flagship|EI_SiLK_LG|EI_SiLK_MNN|SiLKMatcher|
                 EIM_stage2_SiLK_LG] [--no-trace]

Builds the full-width flagship EIM of `ei_nexus_tpu_torch` (bf16, B=8,
random weights from --seed) on bursty events. `--path forward` (default)
voxelizes on the card and runs the inference forward, with LightGlue's
attention as --attention gives it: "auto" (kernels A and B), "flash"
(kernel G) or "qblock" ("auto" with block_q=64: kernel E); with --pose
the forward is chained with the 5-point RANSAC pose tail as chip_smoke.py's
serving phase chains it, and the pose tail alone (on one forward's
matches) is traced as well. `--path stage2` runs the stage-2 training step
(both extractors frozen, LightGlue trained with AdamW; the same batch and
random slot fill every step), `--path stage1` the stage-1 step (the event
extractor trained against the frozen SuperPoint, as chip_smoke.py's
phase 9 runs it; the same batch every step). `--model` swaps the flagship
for one of the SiLK family's configs (`flagship.silk_config`, bf16, as
chip_smoke.py's phase 10 runs them) in the forward and stage-2 paths;
SiLKMatcher matches the frame against itself shifted by 2 px. After a
warm-up it traces --iters runs with
torch.profiler and prints the device time by kernel group (the port's
kernels A-G and the Hopper loops' pack pass, the pose tail's QR, SVD and
sampling, convolutions, matrix products, norms, voxel scatter, sorting,
the optimizer, everything else),
the device's busy time (the union of its operations' intervals) and idle
share of the traced wall time, the 25 heaviest kernels, and by each of
the program's `ei.` spans (`utils/profiling.py`) its device ms, the part
its own body launched, its launches and its host ms in calls that waited
on the card; then, over a second traced window that records input
shapes, the 25 heaviest operators by their own device time and the device
time by each operator's largest input; unless --no-trace, writes the chrome trace to
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

from ei_nexus_tpu_torch.utils.profiling import SpanTrace  # noqa: E402

# kernel-name fragment -> group, first match wins
GROUPS = (
    ("attention_pack_kernel", "pack pass (A, B, D, E, F, G)"),
    ("attention_pack_tf32_kernel", "pack pass, float32 (A, B, D, E, F, G)"),
    ("self_attention_tf32_kernel", "A self_attention_rot"),
    ("cross_attention_tf32_kernel", "B cross_attention_bidir"),
    ("attention_fwd_tf32_kernel", "D attention_fwd"),
    ("qblock_attention_tf32_kernel", "E qblock_attention"),
    ("flash_segment_tf32_kernel", "G flash_attention"),
    ("attention_bwd_rowsum_tf32_kernel", "F attention_bwd"),
    ("attention_bwd_tf32_kernel", "F attention_bwd"),
    ("self_attention_sm90_kernel", "A self_attention_rot"),
    ("attention_fwd_sm90_kernel", "D attention_fwd"),
    ("flash_segment_sm90_kernel", "G flash_attention"),
    ("qblock_attention_sm90_kernel", "E qblock_attention"),
    ("cross_attention_sm90_kernel", "B cross_attention_bidir"),
    ("attention_bwd_sm90_kernel", "F attention_bwd"),
    ("nms_kernel", "C nms_rounds"),
    ("bwd_rowsum_kernel", "F attention_bwd"),
    ("multi_tensor_apply", "optimizer (AdamW, foreach)"),
    ("upsample", "descriptor upsampling (bilinear)"),
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


def group_of(name: str) -> str:
    for frag, group in GROUPS:
        if frag in name:
            return group
    return "other"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--path", choices=("forward", "stage1", "stage2"),
                    default="forward")
    ap.add_argument("--attention", choices=("auto", "flash", "qblock"),
                    default="auto")
    ap.add_argument("--pose", action="store_true")
    ap.add_argument("--model", default="flagship",
                    choices=("flagship", "EI_SiLK_LG", "EI_SiLK_MNN",
                             "SiLKMatcher", "EIM_stage2_SiLK_LG"))
    ap.add_argument("--no-trace", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_forward: no CUDA device", file=sys.stderr)
        return 2
    B = 8
    if args.path == "stage2":
        runs = {"step": stage2_runner(B, args.seed, args.model)}
    elif args.path == "stage1":
        runs = {"stage-1 step": stage1_runner(B, args.seed)}
    else:
        runs = forward_runners(B, args.seed, args.attention, args.pose,
                               args.model)
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

    # the device's operations, without the ranges the profiler and the
    # program's spans annotate on its timeline
    spans = SpanTrace(prof.events())
    by_name, by_group = {}, {}
    for name, t0, t1, _ in spans.ops:
        by_name[name] = by_name.get(name, 0.0) + t1 - t0
        g = group_of(name)
        by_group[g] = by_group.get(g, 0.0) + t1 - t0
    kernel_ms = sum(by_name.values()) / 1e3
    busy_ms = spans.busy_us / 1e3
    per = args.iters
    print(f"{torch.cuda.get_device_name(0)}: {per} traced runs of {what} "
          f"(B={B}), wall {wall_ms / per:.3f} ms each (host clock, traced), "
          f"device busy {busy_ms / per:.3f} ms each, idle share "
          f"{1 - busy_ms / wall_ms:.3f}")
    print(f"device time per {what} by group (summed, "
          f"{kernel_ms / per:.3f} ms):")
    for g, us in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"  {us / 1e3 / per:9.3f} ms  "
              f"{100 * us / 1e3 / kernel_ms:5.1f}%  {g}")
    print(f"heaviest kernels per {what}:")
    for n, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:25]:
        print(f"  {us / 1e3 / per:9.3f} ms  {n[:110]}")
    rows = spans.table()
    print(f"by span per {what}: device ms (own body), launches (own body), "
          f"host ms waiting, count; {spans.launches() / per:.0f} launches "
          f"inside a span")
    for name, r in sorted(rows.items()):
        print(f"  {r['device_us'] / 1e3 / per:9.3f} "
              f"({r['self_device_us'] / 1e3 / per:8.3f}) ms  "
              f"{r['launches'] / per:6.0f} ({r['self_launches'] / per:5.0f})"
              f"  {r['wait_us'] / 1e3 / per:8.3f} ms  "
              f"{r['count'] / per:4.0f}x  {name}")
    # the operators that launched them (host-side events), with their
    # input shapes: which tensors the device time is spent on. A second
    # traced window: recording shapes costs the host enough to move the
    # idle share above
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as shaped:
        for _ in range(args.iters):
            run()
        torch.cuda.synchronize()
    ops = [a for a in shaped.key_averages(group_by_input_shape=True)
           if a.device_type == torch.autograd.DeviceType.CPU
           and a.self_device_time_total > 0]
    print(f"heaviest operators per {what} (self device time, input "
          f"shapes):")
    for a in sorted(ops, key=lambda a: -a.self_device_time_total)[:25]:
        print(f"  {a.self_device_time_total / 1e3 / per:9.3f} ms  "
              f"{a.count // per:4d}x  {a.key[:40]:40s} "
              f"{str(a.input_shapes)[:90]}")
    by_shape = {}
    for a in ops:
        shapes = [tuple(x) for x in a.input_shapes
                  if x and all(isinstance(d, int) for d in x)]
        big = max(shapes, key=lambda x: int(np.prod(x)), default=())
        by_shape[big] = by_shape.get(big, 0.0) + a.self_device_time_total
    shaped_ms = sum(by_shape.values()) / 1e3
    print(f"device time per {what} by the operator's largest input "
          f"(second window, {shaped_ms / per:.3f} ms attributed):")
    for shape, us in sorted(by_shape.items(), key=lambda kv: -kv[1])[:12]:
        print(f"  {us / 1e3 / per:9.3f} ms  "
              f"{100 * us / 1e3 / shaped_ms:5.1f}%  {list(shape)}")
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
        "launches_in_spans": spans.launches() / per,
        "groups_ms": {g: us / 1e3 / per for g, us in by_group.items()},
        "spans_device_ms": {n: r["device_us"] / 1e3 / per
                            for n, r in rows.items()}}))


def forward_runners(B: int, seed: int, attention: str, pose: bool,
                    model_name: str = "flagship"):
    """{name: run}: one inference forward of the flagship, or of the SiLK
    config `model_name` (voxel grid included), with the given attention
    setting; with `pose`, the forward chained with the pose tail, and the
    pose tail alone on one forward's matches."""
    from ei_nexus_tpu_torch.data.synth import bursty_event_batch
    from ei_nexus_tpu_torch.flagship import build_flagship, build_silk
    from ei_nexus_tpu_torch.metrics.ransac import estimate_pose_batch
    from ei_nexus_tpu_torch.train.steps import batch_representation

    max_events = 1 << 17
    if model_name == "flagship":
        model, (H, W, bins) = build_flagship(
            dtype="bfloat16", generator=torch.Generator().manual_seed(seed),
            attention_impl="flash" if attention == "flash" else "auto",
            block_q=64 if attention == "qblock" else 0)
    else:
        model, (H, W, bins) = build_silk(
            model_name, generator=torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    ev = bursty_event_batch(rng, B, int(max_events * 0.95), max_events, H, W)
    ev = {k: torch.as_tensor(v).cuda() for k, v in ev.items()}
    image = torch.as_tensor(
        rng.uniform(0, 255, (B, H, W, 1)).astype(np.float32)).cuda()

    @torch.inference_mode()
    def forward():
        if model_name == "SiLKMatcher":
            return model(image, torch.roll(image, 2, dims=2))
        rep, mask = batch_representation(ev, "VoxelGrid", bins, H, W)
        return model(rep, image, mask)

    name = (f"forward ({attention})" if model_name == "flagship"
            else f"{model_name} forward ({attention})")
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


def stage2_runner(B: int, seed: int, model_name: str = "flagship"):
    """One stage-2 training step of the flagship (or of the SiLK config
    `model_name`), the same batch and slot fill every time (as
    chip_smoke.py's stage-2 phase)."""
    from ei_nexus_tpu_torch.data.synth import stage2_batch
    from ei_nexus_tpu_torch.flagship import (build_silk,
                                             build_stage2_flagship,
                                             stage2_train_state)
    from ei_nexus_tpu_torch.train.steps import make_stage2_train_step

    max_events = 1 << 17
    if model_name == "flagship":
        model, (H, W, bins) = build_stage2_flagship(
            dtype="bfloat16", generator=torch.Generator().manual_seed(seed))
    else:
        model, (H, W, bins) = build_silk(
            model_name, generator=torch.Generator().manual_seed(seed),
            training_heads=True)
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


def stage1_runner(B: int, seed: int):
    """One stage-1 training step of the flagship on the same batch every
    time (as chip_smoke.py's phase 9)."""
    from ei_nexus_tpu_torch.data.synth import bursty_event_batch
    from ei_nexus_tpu_torch.flagship import (STAGE1_LOSSES,
                                             build_stage1_flagship,
                                             stage1_train_state)
    from ei_nexus_tpu_torch.losses import build_losses
    from ei_nexus_tpu_torch.train.steps import make_stage1_train_step

    max_events = 1 << 17
    model, (H, W, bins) = build_stage1_flagship(
        dtype="bfloat16", generator=torch.Generator().manual_seed(seed))
    state = stage1_train_state(model, steps_per_epoch=100)
    rng = np.random.default_rng(seed)
    view = bursty_event_batch(rng, B, int(max_events * 0.95), max_events,
                              H, W)
    view["image"] = rng.uniform(0, 255, (B, H, W, 1)).astype(np.float32)
    batch = ({k: torch.as_tensor(v).cuda() for k, v in view.items()},)
    step = make_stage1_train_step(build_losses(STAGE1_LOSSES), "VoxelGrid",
                                  bins, H, W)
    return lambda: step(state, batch)


if __name__ == "__main__":
    sys.exit(main())
