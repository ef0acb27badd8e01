#!/usr/bin/env python
"""Float32 kernels A and B (the 3xTF32 loop of csrc/flash_tf32.cuh) against
variants of their own source, on one GPU.

    python tools/time_tf32_variants.py [--batch 8 1] [--calls 50]

Builds copies of csrc/ into a temporary directory, each with one text edit
of csrc/flash_tf32.cuh (`VARIANTS`: the softmax's exp as expf of the
difference; three K/V^T stages in place of two), and the unedited source, with nvcc (all at once); loads each
library's self_attention and cross_attention entry points; and, at
(B, 4, 1024, 64) for each --batch, packs A's and B's float32 operands
once (the shipped pack pass) and times each build's loop on the same
planes by device time (torch.profiler, --calls calls) in turns (each
build, then each in reverse order), after checking its result against
the plain version (float32 tolerance, 1e-4 x max(1, max|ref|)). Prints a
line a turn and, last, one JSON object: {"card", "shape", "loop_ms":
{batch: {variant: [ms, ...]}}, "max_abs_err"}. Raises if an edit's text
is gone from the source. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from ei_nexus_tpu_torch.ops import attention_kernels as ak  # noqa: E402
from ei_nexus_tpu_torch.ops import cuda_build  # noqa: E402

# variant -> (text of csrc/flash_tf32.cuh, what replaces it)
VARIANTS = {
    "expf": (
        ("alpha[hr] = exp_diff(m[hr], m_new);",
         "alpha[hr] = m[hr] == -INFINITY ? 0.f : expf(m[hr] - m_new);"),
        ("const float p = exp_diff(s[4 * j + 2 * hr + e], m_new);",
         "const float p = expf(s[4 * j + 2 * hr + e] - m_new);"),
    ),
    "three stages": (
        ("constexpr int kStages = 2;", "constexpr int kStages = 3;"),
    ),
}


def build(root: Path) -> dict:
    """{variant: {"self_attention": CDLL, "cross_attention": CDLL}}, the
    shipped source as "shipped"."""
    jobs = {}
    for name, edits in {"shipped": (), **VARIANTS}.items():
        d = root / name.replace(" ", "_")
        shutil.copytree(cuda_build.CSRC, d)
        header = d / "flash_tf32.cuh"
        src = header.read_text()
        for old, new in edits:
            if old not in src:
                raise RuntimeError(f"{name}: {old!r} is gone from "
                                   f"flash_tf32.cuh")
            src = src.replace(old, new)
        header.write_text(src)
        for lib in ("self_attention", "cross_attention"):
            out = d / f"lib{lib}.so"
            jobs[name, lib] = (subprocess.Popen(
                [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o",
                 str(out), str(d / f"{lib}.cu")], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True), out)
    libs = {}
    for (name, lib), (proc, out) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name} {lib}:\n{log}")
        dll = ctypes.CDLL(str(out))
        for fn, (argtypes, restype) in cuda_build.SIGNATURES[lib].items():
            getattr(dll, fn).argtypes = argtypes
            getattr(dll, fn).restype = restype
        libs.setdefault(name, {})[lib] = dll
    return libs


def loops(x):
    """(self call, cross call, plain results): each call takes the
    libraries of a build and runs its float32 loops on planes packed once
    by the shipped pack pass."""
    q, k, v = x["q"], x["k"], x["v"]
    B, h, N, d = q.shape
    rot = tuple(t.contiguous() for t in x["rot"])
    bias0 = ak.key_bias(x["mask0"], B, N, "cuda")
    bias1 = ak.key_bias(x["mask1"], B, N, "cuda")
    (qp, kp), (vp,) = ak.pack_f32((q, k), (v,), rot)
    (p0, p1), (vt0, vt1) = ak.pack_f32((x["qk0"], x["qk1"]),
                                       (x["v0"], x["v1"]),
                                       kernel="cross_attention")
    out = ak._heads_out(B, h, N, d, q)
    o0, o1 = ak._heads_out(B, h, N, d, q), ak._heads_out(B, h, N, d, q)
    ost = ak.int64_array(out.stride()[:3])
    ost2 = ak.int64_array(o0.stride()[:3] + o1.stride()[:3])

    def self_call(libs):
        ak.check(libs["self_attention"].ei_self_attention_tf32(
            qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), bias0.data_ptr(),
            out.data_ptr(), ost, B, h, N, d ** -0.5,
            torch.cuda.current_stream().cuda_stream), "self_attention")
        return (out,)

    def cross_call(libs):
        ak.check(libs["cross_attention"].ei_cross_attention_tf32(
            p0.data_ptr(), p1.data_ptr(), vt0.data_ptr(), vt1.data_ptr(),
            bias0.data_ptr(), bias1.data_ptr(), o0.data_ptr(),
            o1.data_ptr(), ost2, B, h, N, N,
            torch.cuda.current_stream().cuda_stream), "cross_attention")
        return o0, o1

    want_self = (ak.self_attention_plain(q, k, v, x["mask0"], rot=x["rot"]),)
    want_cross = ak.cross_attention_bidir_plain(
        x["qk0"], x["qk1"], x["v0"], x["v1"], x["mask0"], x["mask1"])
    return {"self_attention": (self_call, want_self),
            "cross_attention": (cross_call, want_cross)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[8, 1])
    ap.add_argument("--calls", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_tf32_variants: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.nvidia_smi_line()
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(Path(tmp))
        names = list(libs)
        order = names + names[::-1]
        gen = torch.Generator(device="cuda").manual_seed(0)
        result, worst = {}, 0.0
        for batch in args.batch:
            cs.MAIN_B = batch
            x = cs.attention_inputs(torch.float32, gen)
            result[batch] = {}
            for kernel, (call, want) in loops(x).items():
                for name in order:
                    got = call(libs[name])
                    torch.cuda.synchronize()
                    for a, b in zip(got, want):
                        e = float((a - b).abs().max())
                        bound = 1e-4 * max(1.0, float(b.abs().max()))
                        cs.require(e <= bound, f"{name} {kernel}: {e:.3e}")
                        worst = max(worst, e)
                    ms = cs._sum_ms(cs.device_ms(
                        lambda: call(libs[name]), args.calls), "tf32_kernel")
                    result[batch].setdefault(kernel, {}).setdefault(
                        name, []).append(ms)
                    print(f"B={batch} {kernel} {name}: loop {ms:.4f} ms a "
                          f"call", flush=True)
    print(json.dumps({"card": card, "shape": [None, 4, 1024, 64],
                      "loop_ms": result, "max_abs_err": worst}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
