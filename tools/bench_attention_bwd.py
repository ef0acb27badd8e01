#!/usr/bin/env python
"""Kernels D and F (the attention forward and backward of the training
path) and the stage-2 step they serve, on the card, through the entry
points the training path calls.

 1. F against its plain version (`fused_attention_bwd_plain`) on the inputs
    where dP - c cancels (`tests/torch_bwd_cases.py`: collapsed value rows,
    one-hot softmax rows; (2, 4, 1024, 64), bfloat16 and float32): D then F
    through `fused_attention`'s autograd, the relative norm of dq, dk, dv;
 2. D's and F's device time a call at the flagship's self-attention (B=8,
    h=4, N=M=1024, d=64, in `--dtype`; q and k head views, v the stride-3
    view of a Wqkv output, dO autograd's (B, h, N, d) view of a (B, N, h,
    d) buffer), traced by torch.profiler (`chip_smoke.device_ms`, which
    traces again where the profiler lost events) over the wrappers alone, by
    launch: D's pack pass and loop; F's pack pass, c pass and loop, and
    the loop's two block kinds each alone (`blocks`); SDPA's device time
    on the same operands (forward; backward as (forward + backward) -
    forward), the yardstick;
 3. the flagship's stage-2 step (B=8, LightGlue in `--dtype`, the pose +
    depth route): `steps` steps back to back with a CUDA event between
    each, the window's mean ms and the min, median and max of single
    steps, and the peak memory allocated over them; then the card's busy
    ms a step over 3 traced steps (all kernels, and D's, F's and the pack
    passes' share), whose ratio to the step's ms says how far the host
    paces it.

`--dtype float32` times D's and F's float32 instances (3xTF32 on the
tensor cores) and the step built with dtype="float32", the type the
`train_matcher` entry takes from its configs. Prints one JSON line, with
the card's name and power limit.
Needs one card; run from the repository's root (or from a parent
checkout with this file and tests/torch_bwd_cases.py copied in, to time
both in turns):

    python tools/bench_attention_bwd.py [--steps 24] [--dtype float32]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
# the repository, and tests/ for the cases (an installed package named
# `tests` may shadow the directory as a package)
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

from chip_smoke import device_ms, nvidia_smi_line  # noqa: E402


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def cases() -> dict:
    """{(case, dtype): [rel dq, rel dk, rel dv]} of F through autograd
    against the plain version."""
    from ei_nexus_tpu_torch.ops import attention_kernels as ak
    from torch_bwd_cases import CASES, bwd_case
    B, h, N, d = 2, 4, 1024, 64
    out = {}
    for case in CASES:
        arrays = [torch.from_numpy(a).cuda()
                  for a in bwd_case(case, B, h, N, N, d)]
        mask = arrays.pop()
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, do = (a.to(dtype) for a in arrays)
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            o = ak.fused_attention(*leaves, mask)
            got = torch.autograd.grad(o, leaves, do)
            bias = ak.key_bias(mask, B, N, "cuda")
            want = ak.fused_attention_bwd_plain(q, k, v, bias, do, d ** -0.5)
            out[f"{case} {str(dtype)[6:]}"] = [rel(a, b)
                                               for a, b in zip(got, want)]
    return out


def _by_launch(times: dict, parts: dict) -> dict:
    """{part: device ms} of a trace's {kernel name: ms}: each part the sum
    over the names that hold all of its fragments and none of its
    exclusions ((fragments, exclusions))."""
    return {part: sum(ms for n, ms in times.items()
                      if all(f in n for f in frags)
                      and not any(x in n for x in skip))
            for part, (frags, skip) in parts.items()}


def fused_device_ms(dtype: torch.dtype) -> dict:
    """D's and F's device ms a call at the flagship's self-attention in
    `dtype`, by launch, and SDPA's on the same operands."""
    import torch.nn.functional as F
    from ei_nexus_tpu_torch.ops import attention_kernels as ak
    B, h, N, d = 8, 4, 1024, 64
    scale = d ** -0.5
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k = (torch.randn(B, N, h, d, generator=g, device="cuda").to(
        dtype).transpose(1, 2) for _ in range(2))
    v = torch.randn(B, N, h, d, 3, generator=g, device="cuda").to(
        dtype).transpose(1, 2)[..., 2]
    mask = torch.rand(B, N, generator=g, device="cuda") > 0.2
    bias = ak.key_bias(mask, B, N, "cuda")
    do = torch.randn(B, N, h, d, generator=g, device="cuda").to(
        dtype).permute(0, 2, 1, 3)
    _, stats, v_read = ak.attention_fwd(q, k, v, bias, scale)
    d_all = device_ms(lambda: ak.attention_fwd(q, k, v, bias, scale))
    f_all = device_ms(lambda: ak.attention_bwd(q, k, v_read, do, bias,
                                               stats, scale))
    loop = (("attention_bwd",), ("rowsum",))
    f_parts = _by_launch(f_all, {"pack": (("pack",), ()),
                                 "c pass": (("rowsum",), ()), "loop": loop})
    for blocks, kind in ((1, "dK/dV blocks alone"), (2, "dQ blocks alone")):
        try:
            f_parts[kind] = _by_launch(device_ms(lambda: ak.attention_bwd(
                q, k, v_read, do, bias, stats, scale, blocks=blocks)),
                {kind: loop})[kind]
        except ValueError:  # an F that times its block kinds in bf16 only
            f_parts[kind] = None
    # SDPA on contiguous copies (its fused paths want a unit d stride) with
    # the same bool mask
    qg, kg, vg = (t.detach().contiguous().requires_grad_() for t in (q, k, v))
    am = mask[:, None, None, :]

    def sdpa():
        return F.scaled_dot_product_attention(qg, kg, vg, attn_mask=am,
                                              scale=scale)

    def sdpa_fwd():
        with torch.no_grad():
            sdpa()

    sdpa_f = sum(device_ms(sdpa_fwd).values())
    sdpa_fb = sum(device_ms(lambda: torch.autograd.grad(
        sdpa(), (qg, kg, vg), do.contiguous())).values())
    return {
        "d": {"total": sum(d_all.values()),
              **_by_launch(d_all, {"pack": (("pack",), ()),
                                   "loop": (("attention_fwd",), ())}),
              "kernels": {n[:60]: ms for n, ms in d_all.items()}},
        "f": {"total": sum(f_all.values()), **f_parts,
              "kernels": {n[:60]: ms for n, ms in f_all.items()}},
        "sdpa": {"fwd": sdpa_f, "bwd": sdpa_fb - sdpa_f}}


def stage2_ms(steps: int, dtype: str) -> dict:
    """The flagship's stage-2 step built with `dtype`: the kernels one
    step launches, mean ms over `steps` back to back and the spread of
    single steps."""
    from ei_nexus_tpu_torch.data.synth import stage2_batch
    from ei_nexus_tpu_torch.flagship import (build_stage2_flagship,
                                             stage2_train_state)
    from ei_nexus_tpu_torch.train.steps import make_stage2_train_step
    B, max_events = 8, 1 << 17
    model, (H, W, bins) = build_stage2_flagship(
        dtype=dtype, generator=torch.Generator().manual_seed(0))
    state = stage2_train_state(model, steps_per_epoch=100)
    data0, data1, T01, T10 = stage2_batch(np.random.default_rng(0), B,
                                          int(max_events * 0.95),
                                          max_events, H, W)
    batch = ({k: torch.as_tensor(v).cuda() for k, v in data0.items()},
             {k: torch.as_tensor(v).cuda() for k, v in data1.items()},
             torch.as_tensor(T01).cuda(), torch.as_tensor(T10).cuda())
    step = make_stage2_train_step("VoxelGrid", bins, H, W)
    fill = torch.Generator(device="cuda")
    for _ in range(3):
        fill.manual_seed(1)
        step(state, batch, fill)
    # the kernels one step launches (D, F, C)
    from ei_nexus_tpu_torch.ops import attention_kernels as ak
    from ei_nexus_tpu_torch.ops import nms_kernel as nk
    counters = {"attention_fwd": ak.attention_fwd,
                "attention_bwd": ak.attention_bwd,
                "nms_rounds": nk.nms_rounds}
    before = {n: f.launches for n, f in counters.items()}
    fill.manual_seed(1)
    step(state, batch, fill)
    launches = {n: f.launches - before[n] for n, f in counters.items()}
    events = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    torch.cuda.reset_peak_memory_stats()
    events[0].record()
    for i in range(steps):
        fill.manual_seed(1)
        step(state, batch, fill)
        events[i + 1].record()
    torch.cuda.synchronize()
    each = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    def one():
        fill.manual_seed(1)
        step(state, batch, fill)
    busy = device_ms(one, iters=3)
    return {"mean": events[0].elapsed_time(events[-1]) / steps,
            "min": min(each), "median": float(np.median(each)),
            "max": max(each), "steps": steps, "launches": launches,
            "peak_gb": peak_gb,
            "busy_ms": {"all": sum(busy.values()),
                        **_by_launch(busy, {
                            "D": (("attention_fwd",), ()),
                            "F": (("attention_bwd",), ()),
                            "pack": (("pack",), ())})}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=24)
    p.add_argument("--dtype", choices=("bfloat16", "float32"),
                   default="bfloat16")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_attention_bwd: no CUDA device", file=sys.stderr)
        return 2
    from ei_nexus_tpu_torch.ops import cuda_build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t = time.perf_counter()
    cuda_build.build()
    built_s = time.perf_counter() - t
    print(json.dumps({
        "card": nvidia_smi_line(), "root": str(ROOT), "build_s": built_s,
        "dtype": args.dtype, "cases_rel_dq_dk_dv": cases(),
        "device_ms": fused_device_ms(getattr(torch, args.dtype)),
        "stage2_step_ms": stage2_ms(args.steps, args.dtype)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
