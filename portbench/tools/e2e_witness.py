"""LightGlue judged end to end: the reference's matcher run on the
reference's own keypoints and descriptors, against the program's log
assignment, beside the benchmark's `la_gap` (which runs the reference's
matcher on the program's keypoints).

    python3 portbench/tools/e2e_witness.py --workload eim_sp_lg.serve_b16 \
        --seeds 2147496031,2147496032 [--seconds 3]

For each seed the serving cell runs as the benchmark runs it, and after
its own judgement every pair of the kept batches is compared again. Per
pair and side: how many slots differ from the program's in position or
validity, and how many valid keypoints lie in one set and not the other.
Where both sets agree, the reference's slots are put in the program's
order (ties among equal scores may order them otherwise), its matcher
runs on them, and the pair's gap is `compare.matcher_gaps`. One line a
seed gives the worst gap, the pairs compared, and the run's `la_gap`.
Invalid slots take part in LightGlue's unmasked dual softmax, so a pair
whose invalid slots differ in position is counted apart and not compared.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent.parent))

from portbench.harness import common  # noqa: E402


def program_order(prog: dict, ref: dict, j: int):
    """The permutation that puts pair j's reference slots in the program's
    order, or None where the two differ in a valid keypoint or an invalid
    slot's position; and (slots out of order, keypoints in one set only)."""
    import torch
    pp = prog["sparse_positions"][j, :, :2]
    pv = prog["sparse_valid"][j]
    rp, rv = ref["positions"][j, :, :2], ref["valid"][j]
    off = int(((pp != rp).any(-1) | (pv != rv)).sum())
    where = {tuple(x): i for i, x in enumerate(rp.tolist())}
    perm = [where.get(tuple(x)) for x in pp.tolist()]
    valid_p = {tuple(x) for x, ok in zip(pp.tolist(), pv.tolist()) if ok}
    valid_r = {tuple(x) for x, ok in zip(rp.tolist(), rv.tolist()) if ok}
    apart = len(valid_p ^ valid_r)
    if apart or None in perm or len(set(perm)) != len(perm):
        return None, off, apart
    return torch.tensor(perm, device=pp.device), off, apart


def witness(cell, sd, pool_np, kept, device) -> dict:
    import torch
    from portbench.harness import compare
    ref = common.reference_module(cell["config_name"])
    cfg = cell["config"]
    chunk = cell["traffic"].get("check_chunk", 4)
    gaps, off, apart, skipped = [], 0, 0, 0
    with torch.no_grad():
        for idx, _, _, m in kept:
            b = {k: torch.as_tensor(v).to(device)
                 for k, v in pool_np[idx].items()}
            voxel, occ = ref.representation(cfg["shape"], b)
            for s in range(0, voxel.shape[0], chunk):
                sl = slice(s, s + chunk)
                own = ref.extract_pair(cfg["model"], sd, voxel[sl], occ[sl],
                                       b["image"][sl])
                progs = [{k: v[sl] for k, v in m[f"input_feats{i}"].items()}
                         for i in (0, 1)]
                for j in range(voxel[sl].shape[0]):
                    feats = []
                    for prog, r in zip(progs, own):
                        perm, o, a = program_order(prog, r, j)
                        off, apart = off + o, apart + a
                        if perm is not None:
                            feats.append({
                                "sparse_positions": r["positions"][j:j + 1,
                                                                   perm],
                                "sparse_valid": r["valid"][j:j + 1, perm],
                                "sparse_descriptors":
                                    r["descriptors"][j:j + 1, perm],
                                "image_size": prog["image_size"][j:j + 1]})
                    if len(feats) < 2:
                        skipped += 1
                        continue
                    r_la, r_m0, mask0, mask1 = ref.match(cfg["model"], sd,
                                                         *feats)
                    la = m["log_assignment"][sl][j:j + 1]
                    m0 = m["matches0"][sl][j:j + 1]
                    gaps.append(compare.matcher_gaps(la, m0, r_la, r_m0,
                                                     mask0, mask1)["la_gap"])
    return {"la_gap_end_to_end": compare.worst(gaps) if gaps else None,
            "pairs_compared": len(gaps), "pairs_not_compared": skipped,
            "slots_out_of_order": off, "keypoints_in_one_set_only": apart}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", default="eim_sp_lg.serve_b16")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true",
                    help="the CPU tests' sizes (a look at the tool only)")
    args = ap.parse_args(argv)
    common.prepare_environment()
    from portbench import run as bench_run
    from portbench.harness import serve
    cell = (common.tiny_cell if args.tiny else common.load_cell)(
        args.workload)
    judge = serve.judge
    found = {}

    def judge_and_witness(cell, sd, pool_np, kept, device):
        found.update(witness(cell, sd, pool_np, kept, device))
        return judge(cell, sd, pool_np, kept, device)

    serve.judge = judge_and_witness
    try:
        for s in [int(s) for s in args.seeds.split(",") if s]:
            line = bench_run.execute(cell, s, args.seconds, False,
                                     args.device, time.perf_counter())
            print(json.dumps({"seed": s, **found,
                              "la_gap": line["checks"]["la_gap"]["value"],
                              "correct": line["correct"]}), flush=True)
    finally:
        serve.judge = judge
    return 0


if __name__ == "__main__":
    sys.exit(main())
