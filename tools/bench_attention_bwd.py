#!/usr/bin/env python
"""Kernel F (the attention backward) and the stage-2 step it serves, on the
card, through the entry points the training path calls.

 1. F against its plain version (`fused_attention_bwd_plain`) on the inputs
    where dP - c cancels (`tests/torch_bwd_cases.py`: collapsed value rows,
    one-hot softmax rows; (2, 4, 1024, 64), bfloat16 and float32): D then F
    through `fused_attention`'s autograd, the relative norm of dq, dk, dv;
 2. F's device time a call at the flagship's self-attention (B=8, h=4,
    N=M=1024, d=64, in `--dtype`; q and k head views, v the stride-3 view
    of a Wqkv output, which D packs in bf16 and hands to F), traced by
    torch.profiler over the backward alone, by kernel name;
 3. the flagship's stage-2 step (B=8, LightGlue in `--dtype`, the pose +
    depth route): `steps` steps back to back with a CUDA event between
    each, the window's mean ms and the min, median and max of single
    steps.

`--dtype float32` times F's float32 instance and the step built with
dtype="float32", the type the `train_matcher` entry takes from its
configs. Prints one JSON line, with the card's name and power limit.
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


def f_device_ms(dtype: torch.dtype) -> dict:
    """{kernel name: device ms a call} of the backward of one
    `fused_attention` call at the flagship's self-attention in `dtype`."""
    from ei_nexus_tpu_torch.ops import attention_kernels as ak
    B, h, N, d = 8, 4, 1024, 64
    g = torch.Generator(device="cuda").manual_seed(0)
    qk = [torch.randn(B, N, h, d, generator=g, device="cuda").to(
        dtype).requires_grad_() for _ in range(2)]
    wqkv = torch.randn(B, N, h, d, 3, generator=g, device="cuda").to(
        dtype).requires_grad_()
    q, k = (t.transpose(1, 2) for t in qk)
    v = wqkv.transpose(1, 2)[..., 2]
    mask = torch.rand(B, N, generator=g, device="cuda") > 0.2
    out = ak.fused_attention(q, k, v, mask)
    do = torch.randn(out.shape, generator=g, device="cuda").to(out.dtype)

    return device_ms(lambda: torch.autograd.grad(out, (*qk, wqkv), do,
                                                 retain_graph=True))


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
    events[0].record()
    for i in range(steps):
        fill.manual_seed(1)
        step(state, batch, fill)
        events[i + 1].record()
    torch.cuda.synchronize()
    each = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    return {"mean": events[0].elapsed_time(events[-1]) / steps,
            "min": min(each), "median": float(np.median(each)),
            "max": max(each), "steps": steps, "launches": launches}


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
    f = f_device_ms(getattr(torch, args.dtype))
    # F's own kernels: in bf16 the loop and the pack pass; in float32 every
    # kernel named for the backward (autograd adds copies around them)
    split = ({"loop": "attention_bwd_sm90_kernel",
              "pack": "attention_pack_kernel"} if args.dtype == "bfloat16"
             else {"f": "bwd"})
    print(json.dumps({
        "card": nvidia_smi_line(), "root": str(ROOT), "build_s": built_s,
        "dtype": args.dtype, "cases_rel_dq_dk_dv": cases(),
        "f_device_ms": {**{k: sum(ms for n, ms in f.items() if frag in n)
                           for k, frag in split.items()},
                        "kernels": {n[:60]: ms for n, ms in f.items()}},
        "stage2_step_ms": stage2_ms(args.steps, args.dtype)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
