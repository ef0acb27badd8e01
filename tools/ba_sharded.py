#!/usr/bin/env python
"""Phase 14b's BA case of chip_smoke.py, repeated: `ba_solve` at
tools/bench_ba.py's size (512 keyframes, 65,536 landmarks, 655,360
observations, 12 LM x 20 CG, Huber 4 px, z_min 0.01, float32) with the
observations split over 2 gloo processes on one card, against one
process, `--repeats` times each way, and once with each planted fault
(`chip_smoke.BA_DP_FAULTS`: the last rank's observations dropped, Hpp
and Hll left un-reduced).

Every (one process, sharded) pair of the same repeat is held by
`chip_smoke.ba_dp_check`; the faults must fail it. For each pair the
JSON line gives the initial relative gap, the final gap and its bound,
the largest gap over the trajectory and the iterations where the costs
part.

Needs one card; run from the repository's root:

    python tools/ba_sharded.py [--repeats 10]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--repeats", type=int, default=10)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("ba_sharded: no CUDA device", file=sys.stderr)
        return 2
    from ei_nexus_tpu_torch.parallel.dryrun import launch

    torch.backends.cuda.matmul.allow_tf32 = False
    ranks = launch(cs.ba_dp_rank, cs.DP_WORLD,
                   (args.repeats, cs.BA_DP_FAULTS), device="cuda",
                   backend="gloo", timeout_s=1200)
    one = cs.ba_dp_cases(None, 0, 1, args.repeats)["solves"]
    pairs = [cs.ba_dp_check(solo, [r["solves"][i] for r in ranks])
             for i, solo in enumerate(one)]
    faults = {f: cs.ba_dp_check(one[0], [r["faults"][f] for r in ranks])
              for f in cs.BA_DP_FAULTS}
    print(json.dumps({
        "card": cs.nvidia_smi_line(), "ranks": cs.DP_WORLD,
        "passed": sum(v["ok"] for v in pairs), "repeats": args.repeats,
        "pairs": pairs,
        "faults": {f: {"ok": v["ok"], "why": v["why"]}
                   for f, v in faults.items()}}))
    return 0 if all(v["ok"] for v in pairs) and not any(
        v["ok"] for v in faults.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
