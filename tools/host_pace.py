#!/usr/bin/env python
"""Whether the host or the card paces a serving cell: the host's time to
enqueue one batch, with no profiler, when the card starts the batch idle
and when the card is held busy for the whole enqueue.

    python tools/host_pace.py [--workload eim_sp_lg.serve_b16] [--seed 0]
        [--reps 5] [--hold-ms 400]

from the root of a checkout, on a machine with a CUDA device. Builds the
cell's model, weights and batch pool as `portbench/` does and enqueues
one batch as its serving driver submits it (copy, voxel grid, forward;
no sync), in turns: "idle", the card empty when the enqueue starts and
running the batch behind it; "held", a `--hold-ms` sleep kernel queued
first, so that the card runs none of the batch while the host enqueues
it. A held enqueue is the host's own cost unless the launch queue fills
(it then lasts about the hold); an idle enqueue longer than the held one
is time the card made the host wait. The held turns are repeated under
`torch.profiler`, which gives the launches a batch and the profiler's
own host cost. Prints one JSON line (ms, medians over `--reps`).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", default="eim_sp_lg.serve_b16")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--hold-ms", type=float, default=400.0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("host_pace: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile
    from ei_nexus_tpu_torch.train.steps import batch_representation
    from ei_nexus_tpu_torch.utils.profiling import LAUNCH_CALLS
    from ei_nexus_tpu_torch.utils.setup import setup
    from portbench.harness import common, data
    from portbench.harness.serve import build_model

    common.prepare_environment()
    torch.set_num_threads(1)
    cell = common.load_cell(args.workload)
    cfg, mix = cell["config"], cell["traffic"]
    shp = cfg["shape"]
    H, W, bins, kind = shp["height"], shp["width"], shp["bins"], shp["kind"]
    seeds = common.seeds(args.seed)
    setup(seeds["host"])
    common.set_tf32(False)
    model, _ = build_model(cfg["model"], "cuda")
    model.eval()
    common.init_weights(model, seeds["weights"], "cuda")
    pool = data.pinned(data.serve_pool(seeds["pool"], mix, H, W), "cuda")

    def enqueue_ms(i: int, hold_cycles: int) -> float:
        torch.cuda.synchronize()
        if hold_cycles:
            torch.cuda._sleep(hold_cycles)
        t = time.perf_counter()
        b = data.to_device(pool[i % len(pool)], "cuda")
        rep, mask = batch_representation(b, kind, bins, H, W, device="cuda")
        with torch.no_grad():
            model(rep, b["image"], mask, None, training=False)
        dt = time.perf_counter() - t
        torch.cuda.synchronize()
        return dt * 1e3

    for i in range(3):                  # builds the kernels
        enqueue_ms(i, 0)
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    start.record()
    torch.cuda._sleep(10 ** 8)
    end.record()
    torch.cuda.synchronize()
    hold = int(10 ** 8 * args.hold_ms / start.elapsed_time(end))
    idle, held = [], []
    for i in range(args.reps):
        idle.append(enqueue_ms(i, 0))
        held.append(enqueue_ms(i, hold))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        traced = [enqueue_ms(i, hold) for i in range(args.reps)]
    # less the hold's own launch, one a turn
    launches = sum(1 for e in prof.events()
                   if e.name in LAUNCH_CALLS) - args.reps
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "workload": args.workload,
        "reps": args.reps, "hold_ms": args.hold_ms,
        "idle_ms": statistics.median(idle), "held_ms": statistics.median(held),
        "held_traced_ms": statistics.median(traced),
        "launches": launches / args.reps,
        "idle_all": idle, "held_all": held, "held_traced_all": traced}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
