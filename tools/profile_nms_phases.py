#!/usr/bin/env python
"""Where the time of kernel C (csrc/nms.cu, fixed-round NMS) goes, phase by
phase, on one GPU.

    python tools/profile_nms_phases.py [--shape 8 264 352] [--radius 4]
        [--rounds 4] [--block 0] [--calls 5]

Builds an instrumented copy of csrc/nms.cu into ei_nexus_tpu_torch/_build/:
thread 0 of block --block stamps the card's %globaltimer (ns) at each phase
boundary of each round (the row pass, the cluster barrier after it, the
copy of the peers' rows into the halo rows, the column pass, the row
dilation, the second barrier, its halo copy, the zeroing), after the load
and after the write-out. Runs the kernel --calls times at the given shape
on a float32 map (30% zeros), checks the last result bit-exact against the
plain version, and prints the last call's phases in microseconds: the
round's phases for every round, and their mean over the rounds. A barrier
phase is the stamping thread's wait, which holds the slowest peer's work;
a pass is that thread's own share. Also prints the uninstrumented kernel's
device time per call (torch.profiler). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from ei_nexus_tpu_torch.ops import cuda_build  # noqa: E402
from ei_nexus_tpu_torch.ops import nms_kernel as nk  # noqa: E402

PHASES = ("row pass", "barrier 1", "halo of rmax", "column pass",
          "row dilation", "barrier 2", "halo of dil", "zeroing")
_STAMP = """
__device__ unsigned long long ei_trace[64];
#define EI_STAMP(k) do { if (blockIdx.x == EI_TRACE_BLOCK && \\
    threadIdx.x == 0) { unsigned long long t; \\
    asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t)); \\
    ei_trace[k] = t; } } while (0)
"""
# (text of csrc/nms.cu, what replaces it): slot 10*it + k stamps the end
# of phase k (1-8) of round it, slot 0 the end of the load, 63 the
# write-out
_EDITS = (
    ("  __syncthreads();\n\n  constexpr int run",
     "  __syncthreads();\n  EI_STAMP(0);\n\n  constexpr int run"),
    ("    cluster.sync();\n    if (nr) pull_halo(cluster, rmax",
     "    EI_STAMP(1 + 10 * it);\n    cluster.sync();\n"
     "    EI_STAMP(2 + 10 * it);\n    if (nr) pull_halo(cluster, rmax"),
    ("rmax, W, R, r0, nr, rows, L);\n    __syncthreads();\n",
     "rmax, W, R, r0, nr, rows, L);\n    __syncthreads();\n"
     "    EI_STAMP(3 + 10 * it);\n"),
    ("    __syncthreads();\n    // 3.",
     "    __syncthreads();\n    EI_STAMP(4 + 10 * it);\n    // 3."),
    ("    cluster.sync();\n    if (nr) pull_halo(cluster, dil",
     "    EI_STAMP(5 + 10 * it);\n    cluster.sync();\n"
     "    EI_STAMP(6 + 10 * it);\n    if (nr) pull_halo(cluster, dil"),
    ("dil, nw, R, r0, nr, rows, L);\n    __syncthreads();\n",
     "dil, nw, R, r0, nr, rows, L);\n    __syncthreads();\n"
     "    EI_STAMP(7 + 10 * it);\n"),
    ("    __syncthreads();\n  }\n\n  // this block's rows",
     "    __syncthreads();\n    EI_STAMP(8 + 10 * it);\n  }\n\n"
     "  // this block's rows"),
    ("  cluster.sync();  // no block leaves",
     "  EI_STAMP(63);\n  cluster.sync();  // no block leaves"),
)


def instrumented_source(block: int) -> str:
    """csrc/nms.cu with the stamps put in; raises if its text moved."""
    src = (cuda_build.CSRC / "nms.cu").read_text()
    src = src.replace('#include "common.cuh"\n',
                      f'#include "common.cuh"\n#define EI_TRACE_BLOCK {block}'
                      + _STAMP, 1)
    for old, new in _EDITS:
        if src.count(old) != 1:
            raise RuntimeError(f"csrc/nms.cu changed: {old[:50]!r} is not "
                               f"there once")
        src = src.replace(old, new)
    return src + ("extern \"C\" int ei_nms_trace(unsigned long long* h) {\n"
                  "  return (int)cudaMemcpyFromSymbol(h, ei_trace, "
                  "sizeof(ei_trace));\n}\n")


def build(block: int) -> ctypes.CDLL:
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = cuda_build.BUILD_DIR / f"nms_phases_{block}.cu"
    lib = cuda_build.BUILD_DIR / f"libnms_phases_{block}.so"
    src.write_text(instrumented_source(block))
    res = subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS,
                          f"-I{cuda_build.CSRC}", "-o", str(lib), str(src)],
                         capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(res.stdout + res.stderr)
    out = ctypes.CDLL(str(lib))
    for fn, (argtypes, restype) in cuda_build.SIGNATURES["nms"].items():
        getattr(out, fn).argtypes = argtypes
        getattr(out, fn).restype = restype
    out.ei_nms_trace.argtypes = [ctypes.c_void_p]
    out.ei_nms_trace.restype = ctypes.c_int
    return out


def device_us(fn, iters: int = 30) -> float:
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA) / iters


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", type=int, nargs=3, default=(8, 264, 352))
    ap.add_argument("--radius", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--block", type=int, default=0)
    ap.add_argument("--calls", type=int, default=5)
    args = ap.parse_args()
    if not 1 <= args.rounds <= 6:
        raise SystemExit("--rounds: 1 to 6 (the stamp table's size)")
    if not torch.cuda.is_available():
        print("profile_nms_phases: no CUDA device", file=sys.stderr)
        return 2
    gen = torch.Generator(device="cuda").manual_seed(0)
    score = torch.rand(*args.shape, generator=gen, device="cuda")
    score = torch.where(score > 0.3, score, torch.zeros_like(score))
    r, n = args.radius, args.rounds
    plain_us = device_us(lambda: nk.nms_rounds(score, r, n))
    lib = build(args.block)
    cuda_build._LIBS["nms"] = lib  # the instrumented build, this process
    for _ in range(args.calls):
        got = nk.nms_rounds(score, r, n)
    torch.cuda.synchronize()
    if not torch.equal(got, nk.nms_rounds_plain(score, r, n)):
        raise AssertionError("instrumented kernel C is not bit-exact")
    stamps = (ctypes.c_ulonglong * 64)()
    cuda_build.check(lib.ei_nms_trace(stamps), "ei_nms_trace")
    t = [int(v) for v in stamps]
    t0 = t[0]
    rounds, prev = [], t0
    for it in range(n):
        row = []
        for k in range(1, len(PHASES) + 1):
            row.append((t[k + 10 * it] - prev) / 1e3)
            prev = t[k + 10 * it]
        rounds.append(row)
    write_us = (t[63] - prev) / 1e3
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    plan = nk.nms_plan(*args.shape, r, n, 4)
    print(f"{smi}: kernel C at {tuple(args.shape)} float32, r={r}, {n} "
          f"rounds, clusters of {plan.cluster} ({plan.rows} rows a block, "
          f"{len(plan.row_strips)} x {len(plan.col_strips)} tiles); "
          f"device time {plain_us:.2f} us a "
          f"call (uninstrumented); block {args.block}, thread 0, last of "
          f"{args.calls} calls:")
    for it, row in enumerate(rounds):
        print(f"  round {it}: " + ", ".join(
            f"{name} {us:.2f}" for name, us in zip(PHASES, row)))
    mean = [sum(row[k] for row in rounds) / n for k in range(len(PHASES))]
    print("  mean round: " + ", ".join(
        f"{name} {us:.2f}" for name, us in zip(PHASES, mean))
        + f"; sum {sum(mean):.2f} us")
    print(f"  write-out {write_us:.2f} us; the stamping block's whole run "
          f"{(t[63] - t0) / 1e3:.2f} us after its load")
    print(json.dumps({"device": smi, "shape": list(args.shape), "radius": r,
                      "rounds": n, "device_us": plain_us,
                      "round_us": rounds, "write_us": write_us}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
