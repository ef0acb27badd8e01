"""Readings for a cell's limits, many seeds in one process on the chip.

    python3 portbench/tools/readings.py --workload <cell> \
        --seeds 11,12,13 [--seconds 3] [--control 21,22,23] \
        [--fault half_batch --fault-seeds 31,32,33]

For each of `--seeds` the cell runs as the benchmark runs it (a short
window, then the checks) and one line `{"role": "program", ...}` gives
every reading. For each of `--control` the lower-precision control runs
in the program's place: the float32 reference with TF32 on (matmuls and
convolutions), the precision just below the configuration's float32 with
TF32 off, judged by the same comparison against the reference in
float32. For each of `--fault-seeds` the cell runs with the fault planted
(`tools/faults.py`). The limits of `workloads/<cell>.json` are set from
these lines: above the program's largest reading, below the smallest the
control or a fault gives.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent.parent))

from portbench.harness import common  # noqa: E402


def serve_control(cell: dict, seed: int, device: str):
    """The served outputs of the reference with TF32 on, in the form the
    serving judge reads, and the weights and pool they came from."""
    import torch
    from portbench.harness import data
    from portbench.harness.serve import build_model
    cfg, mix = cell["config"], cell["traffic"]
    shp = cfg["shape"]
    ref = common.reference_module(cell["config_name"])
    seeds = common.seeds(seed)
    model, _ = build_model(cfg["model"], device)
    sd = {k: v.clone() for k, v in common.init_weights(
        model, seeds["weights"], device).items()}
    del model
    pool_np = data.serve_pool(seeds["pool"], mix, shp["height"],
                              shp["width"])
    kept = []
    common.set_tf32(True)
    with torch.no_grad():
        for idx in range(min(2, len(pool_np))):
            b = {k: torch.as_tensor(v).to(device)
                 for k, v in pool_np[idx].items()}
            voxel, occ = ref.representation(shp, b)
            ev, im = ref.extract_pair(cfg["model"], sd, voxel, occ,
                                      b["image"])
            feats = []
            for out in (ev, im):
                feats.append({"sparse_positions": out["positions"],
                              "sparse_valid": out["valid"],
                              "sparse_descriptors": out["descriptors"],
                              "image_size": torch.tensor(
                                  [[shp["height"], shp["width"]]],
                                  dtype=torch.float32,
                                  device=device).expand(voxel.shape[0], 2)})
            la, m0, _, _ = ref.match(cfg["model"], sd, *feats)
            kept.append((idx, feats[0], feats[1],
                         {"log_assignment": la, "matches0": m0,
                          "input_feats0": feats[0],
                          "input_feats1": feats[1]}))
    common.set_tf32(False)
    return sd, pool_np, kept


def train_control(cell: dict, seed: int, device: str):
    """The stage-2 readings' inputs from the reference with TF32 on: its
    extractor outputs for the checked steps, its losses, first gradient
    and parameters after the last step."""
    import torch
    from portbench.harness import data
    from portbench.harness.serve import build_model
    from portbench.harness.train import make_fills
    cfg, mix = cell["config"], cell["traffic"]
    shp = cfg["shape"]
    ref = common.reference_module(cell["config_name"])
    seeds = common.seeds(seed)
    model, _ = build_model(cfg["stage2_model"], device, training_heads=True)
    sd = {k: v.clone() for k, v in common.init_weights(
        model, seeds["weights"], device).items()}
    names = [n for n, p in model.named_parameters()
             if n.startswith("matcher.")]
    del model
    pool_np = data.stage2_pool(seeds["pool"], mix, shp["height"],
                               shp["width"])
    fills = make_fills(seeds["fill"], cfg, mix, device)
    common.set_tf32(True)
    captured = {"event_extractor": [], "image_extractor": []}
    steps = []
    n = mix["checked_steps"]
    with torch.no_grad():
        for s in range(n):
            b = {k: torch.as_tensor(v).to(device)
                 for k, v in pool_np[s].items()}
            voxel, occ = ref.representation(shp, b)
            ev, im = ref.extract_pair(cfg["stage2_model"], sd, voxel, occ,
                                      b["image"])
            size = torch.tensor([[shp["height"], shp["width"]]],
                                dtype=torch.float32,
                                device=device).expand(voxel.shape[0], 2)
            for side, out in (("event_extractor", ev),
                              ("image_extractor", im)):
                captured[side].append({
                    "sparse_positions": out["positions"],
                    "sparse_valid": out["valid"],
                    "sparse_descriptors": out["descriptors"],
                    "image_size": size})
            steps.append({"feats0": captured["event_extractor"][s],
                          "feats1": captured["image_extractor"][s],
                          "fill": fills[s], "K": b["K"],
                          "depth0": b["depth0"], "depth1": b["depth1"],
                          "T01": b["T01"], "T10": b["T10"]})
    theta0 = {k: sd[k] for k in names}
    losses, g1, theta3 = ref.stage2_steps(cfg["stage2_model"], cfg["train"],
                                          theta0, steps)
    common.set_tf32(False)
    return sd, pool_np, fills, captured, losses, g1, theta0, theta3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", default="")
    ap.add_argument("--fault", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    common.prepare_environment()
    from portbench import run as bench_run
    from portbench.harness import serve, train
    from portbench.tools.faults import plant
    cell = common.load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    for s in seeds:
        line = bench_run.execute(cell, s, args.seconds, False, args.device,
                                 time.perf_counter())
        print(json.dumps({"role": "program", "seed": s,
                          "readings": {k: c["value"] for k, c in
                                       line["checks"].items()},
                          "metrics": line["metrics"]}), flush=True)
    for s in [int(s) for s in args.fault_seeds.split(",") if s]:
        with plant(args.fault):
            line = bench_run.execute(cell, s, args.seconds, False,
                                     args.device, time.perf_counter())
        print(json.dumps({"role": "fault:" + args.fault, "seed": s,
                          "readings": {k: c["value"] for k, c in
                                       line["checks"].items()}}), flush=True)
    for s in [int(s) for s in args.control.split(",") if s]:
        if cell["traffic"]["kind"] == "serve_closed":
            sd, pool_np, kept = serve_control(cell, s, args.device)
            readings, failed = serve.judge(cell, sd, pool_np, kept,
                                           args.device)
        else:
            readings, failed = train.judge(
                cell, *train_control(cell, s, args.device), args.device)
        print(json.dumps({"role": "control", "seed": s,
                          "readings": readings, "failed": failed}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
