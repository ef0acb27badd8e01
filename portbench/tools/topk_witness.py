"""Where the port's keypoint top-k departs from the top-k: the witness of
the fault that keeps `silk_lg.serve_b16` out of the benchmark.

    python3 portbench/tools/topk_witness.py --config silk_lg \
        --seeds 2147484648,2147484651

For each seed the configuration's event extractor runs on every batch of
the serving cell's pool (the seeded weights and pool of a run of
`eim_sp_lg.serve_b16` with the configuration in its place). Its score
map then goes through kernel C's NMS and through both paths of
`ops/detector.py:select_topk_keypoints`: the block top-2 reduction that
the program takes (`min_distance` = radius + 1), and the full sort
(`min_distance` = 0). One line a seed gives the largest score-by-rank
gaps: the program against the reference (`reference/nets.py`), the
program against the block path, and the full-sort path against the
reference. It also gives the largest count of plateau pixels (score
exactly 1.0) that survive the NMS in a map.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent.parent))

from portbench.harness import common  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", default="silk_lg")
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    common.prepare_environment()
    import torch
    from ei_nexus_tpu_torch.ops.detector import nms, select_topk_keypoints
    from ei_nexus_tpu_torch.train.steps import batch_representation
    from ei_nexus_tpu_torch.utils.setup import setup
    from portbench.harness import data
    from portbench.harness.serve import build_model
    from portbench.reference import nets

    common.set_tf32(False)
    cell = common.load_cell("eim_sp_lg.serve_b16", args.config)
    cfg, mix, shp = cell["config"], cell["traffic"], cell["config"]["shape"]
    ref = common.reference_module(cell["config_name"])
    spec = nets.extractor_spec(cfg["model"]["event_extractor"])
    for seed in (int(s) for s in args.seeds.split(",")):
        seeds = common.seeds(seed)
        setup(seeds["host"])
        model, _ = build_model(cfg["model"], "cuda")
        model.eval()
        sd = {k: v.clone() for k, v in common.init_weights(
            model, seeds["weights"], "cuda").items()}
        worst = dict.fromkeys(("program_vs_reference", "program_vs_block",
                               "full_sort_vs_reference", "plateau_pixels"),
                              0.0)
        for batch in data.serve_pool(seeds["pool"], mix, shp["height"],
                                     shp["width"]):
            b = {k: torch.as_tensor(v).cuda() for k, v in batch.items()}
            with torch.no_grad():
                rep, mask = batch_representation(
                    b, shp["kind"], shp["bins"], shp["height"], shp["width"],
                    device="cuda")
                out = model.event_extractor(rep, mask)
                voxel, occ = ref.representation(shp, b)
                for s in range(0, voxel.shape[0], 4):
                    sl = slice(s, s + 4)
                    r = nets.extract(sd, "event_extractor", spec, voxel[sl],
                                     occ[sl])
                    rv = r["positions"][..., 2]
                    nm = nms(out["score"][sl], spec["radius"])
                    block, _ = select_topk_keypoints(
                        nm, spec["top_k"], spec["thresh"], "yx",
                        min_distance=spec["radius"] + 1)
                    full, _ = select_topk_keypoints(
                        nm, spec["top_k"], spec["thresh"], "yx",
                        min_distance=0)
                    prog = out["sparse_positions"][sl][..., 2]
                    for key, gap in (
                            ("program_vs_reference", prog - rv),
                            ("program_vs_block", prog - block[..., 2]),
                            ("full_sort_vs_reference", full[..., 2] - rv)):
                        worst[key] = max(worst[key], float(gap.abs().max()))
                    worst["plateau_pixels"] = max(
                        worst["plateau_pixels"],
                        int((nm == 1.0).flatten(1).sum(1).max()))
        print(json.dumps({"seed": seed, **worst}), flush=True)
        del model
    return 0


if __name__ == "__main__":
    sys.exit(main())
