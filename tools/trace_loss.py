#!/usr/bin/env python
"""How often a torch.profiler trace of a few short calls loses kernel
events, with and without a pause around the traced (active) cycle.

`chip_smoke.trace_events` traces `iters` calls in the profiler's warm-up
cycle and again in its active one, and waits `pause` seconds between the
active cycle's edges and its kernels. This tool traces three short calls
(kernel C at the flagship's (8, 264, 352), kernel G at 2048 tokens in
bfloat16, and one float32 `torch.mm`), 20 calls a trace, `--rounds`
times each with no pause and with `chip_smoke.trace_events`' default,
and counts the traces that `chip_smoke.trace_gaps` finds short (fewer
kernel events than launch calls). Prints one JSON line, with the card's
name and power limit.
Needs one card; run from the repository's root:

    python tools/trace_loss.py [--rounds 40]
"""

from __future__ import annotations

import argparse
import inspect
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=40)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("trace_loss: no CUDA device available", file=sys.stderr)
        return 2
    from ei_nexus_tpu_torch.ops import flash_kernel as fk
    from ei_nexus_tpu_torch.ops import nms_kernel as nk

    gen = torch.Generator(device="cuda").manual_seed(0)
    score = torch.rand(cs.NMS_SHAPE, generator=gen, device="cuda")
    xg = cs.flash_inputs(2048, torch.bfloat16, gen)
    calls = {
        "nms_rounds": lambda: nk.nms_rounds(score, cs.NMS_RADIUS,
                                            cs.NMS_ROUNDS),
        "flash_attention_2048": lambda: fk.flash_attention(
            *xg, cs.MAIN_D ** -0.5),
        "mm": lambda: torch.mm(score[0], score[0].T)}
    pauses = (0.0, inspect.signature(cs.trace_events)
              .parameters["pause"].default)
    short = {f"{name} pause {p}": 0 for name in calls for p in pauses}
    for _ in range(args.rounds):
        for name, fn in calls.items():
            for p in pauses:
                if cs.trace_gaps(cs.trace_events(fn, 20, pause=p)):
                    short[f"{name} pause {p}"] += 1
    print(json.dumps({"traces_each": args.rounds, "short": short,
                      "device": cs.nvidia_smi_line()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
