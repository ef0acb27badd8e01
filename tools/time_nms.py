#!/usr/bin/env python
"""Device time of kernel C (fixed-round NMS, `nms_rounds`) on one GPU, for
one checkout of the repo or several in turns.

    python tools/time_nms.py [--root DIR ...] [--shape 8 264 352 ...]
        [--radius 4] [--rounds 4] [--calls 30]

Each --root (default: this checkout) is timed in a process of its own that
imports that checkout's `ei_nexus_tpu_torch`, which builds its own
csrc/nms.cu; give roots in the order to run them (for two versions:
A B B A). At each --shape a float32 map (30% zeros, from seed 0) is held
bit-exact against that checkout's plain version, then timed by
torch.profiler: the device time of --calls calls, per call. Prints the
card's name and power limit, then one JSON line per root and shape.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def time_here(shapes, radius: int, rounds: int, calls: int) -> list:
    """Time this process's `ei_nexus_tpu_torch` (the first on sys.path)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ei_nexus_tpu_torch.ops import nms_kernel as nk

    rows = []
    for shape in shapes:
        gen = torch.Generator(device="cuda").manual_seed(0)
        score = torch.rand(*shape, generator=gen, device="cuda")
        score = torch.where(score > 0.3, score, torch.zeros_like(score))
        got = nk.nms_rounds(score, radius, rounds)
        if not torch.equal(got, nk.nms_rounds_plain(score, radius, rounds)):
            raise AssertionError(f"kernel C is not bit-exact at {shape}")
        for _ in range(3):
            nk.nms_rounds(score, radius, rounds)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                nk.nms_rounds(score, radius, rounds)
            torch.cuda.synchronize()
        us = sum(e.device_time for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA) / calls
        rows.append({"shape": list(shape), "device_ms": us / 1e3})
    return rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", action="append", default=None)
    ap.add_argument("--shape", type=int, nargs=3, action="append")
    ap.add_argument("--radius", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--calls", type=int, default=30)
    ap.add_argument("--here", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    shapes = [tuple(s) for s in (args.shape or [(8, 264, 352)])]
    if args.here:   # one root, in this process, from PYTHONPATH
        print(json.dumps(time_here(shapes, args.radius, args.rounds,
                                   args.calls)))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("time_nms: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    for root in args.root or [str(HERE)]:
        root = str(Path(root).resolve())
        cmd = [sys.executable, str(Path(__file__).resolve()), "--here",
               "--radius", str(args.radius), "--rounds", str(args.rounds),
               "--calls", str(args.calls)]
        for s in shapes:
            cmd += ["--shape", *map(str, s)]
        res = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                             env=dict(os.environ, PYTHONPATH=root),
                             timeout=900)
        if res.returncode:
            print(res.stdout + res.stderr, file=sys.stderr)
            return res.returncode
        for row in json.loads(res.stdout.strip().splitlines()[-1]):
            print(json.dumps({"root": root, **row}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
