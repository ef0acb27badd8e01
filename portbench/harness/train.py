"""The training driver: the port's stage-2 step
(`train/steps.py:make_stage2_train_step`), step after step as
`train_matcher`'s loop drives it, on one state built at set-up.

Set-up builds the model of the configuration's stage-2 model dict with
LightGlue's training heads, the train state (the configuration's AdamW
and cosine schedule, the config's frozen roots) and the step; it draws
the weights, a pool of `pool` distinct batches with their depth, poses and
intrinsics, and one random slot fill a pool batch (handed in as `fill=`),
from the seed. It then drives that same state through its first
`checked_steps` steps on distinct batches, recording the program's
losses, AdamW's first moment after step 1 and the parameters before and
after; these steps build the kernels and warm every shape. The window
runs steps until `seconds` have passed on the host, then waits for the
device; the rate is all pairs trained over that time.

After the window the reference follows the checked steps from the same
weights, on the extractor outputs the program's frozen extractors gave
those steps (captured by hooks), and the extractor stage is judged by
itself on step 1's batch.
"""

from __future__ import annotations

import time
from typing import Dict

from . import common, compare, data
from .flops import FlopCounter, lightglue_attention_flops
from .serve import build_model, extractor_hooks, lightglue_shape
from .trace import span, traced

KEEP = ("sparse_positions", "sparse_valid", "sparse_descriptors",
        "image_size")


def make_fills(seed: int, cfg: dict, mix: dict, device) -> list:
    """One random slot fill a pool batch, drawn on `device`: per side
    positions uniform over the frame (y, x, 0) and unit normal
    descriptors times the matcher's desc_scale_factor, as the port's
    `random_fill` draws them."""
    import torch
    from portbench.reference.nets import extractor_spec
    gen = torch.Generator(device=device).manual_seed(seed)
    model = cfg["stage2_model"]
    L = model["matcher"].get("max_points_num", 1024)
    scale = model["matcher"].get("desc_scale_factor", 1.0)
    B = mix["batch"]
    size = torch.tensor([cfg["shape"]["height"], cfg["shape"]["width"]],
                        dtype=torch.float32, device=device)
    fills = []
    for _ in range(mix["pool"]):
        sides = []
        for side in ("event_extractor", "image_extractor"):
            D = extractor_spec(model[side])["desc_dim"]
            yx = torch.rand(B, L, 2, generator=gen, device=device) * size
            pos = torch.cat([yx, yx.new_zeros(B, L, 1)], -1)
            n = torch.randn(B, L, D, generator=gen, device=device)
            n = n / n.norm(dim=-1, keepdim=True).clamp(min=1e-12)
            sides.append((pos, n * scale))
        fills.append(tuple(sides))
    return fills


def run(cell: dict, seed: int, seconds: float, trace: bool, device,
        t0: float) -> dict:
    import torch
    from ei_nexus_tpu_torch.train.partition import frozen_roots_from_config
    from ei_nexus_tpu_torch.train.state import create_train_state
    from ei_nexus_tpu_torch.train.steps import make_stage2_train_step
    from ei_nexus_tpu_torch.utils.setup import setup

    cfg, mix = cell["config"], cell["traffic"]
    shp, tr = cfg["shape"], cfg["train"]
    H, W, bins, kind = shp["height"], shp["width"], shp["bins"], shp["kind"]
    cuda = torch.device(device).type == "cuda"
    seeds = common.seeds(seed)
    setup(seeds["host"])
    common.set_tf32(False)
    model, ecfg = build_model(cfg["stage2_model"], device,
                              training_heads=True)
    sd_ref = {k: v.clone()
              for k, v in common.init_weights(model, seeds["weights"],
                                              device).items()}
    opt = tr["optimizer"]
    state = create_train_state(
        model, frozen_roots_from_config(ecfg),
        {"type": "AdamW", "AdamW": {k: opt[k] for k in (
            "weight_decay", "betas", "eps")}},
        {"type": "CosineAnnealingLR",
         "CosineAnnealingLR": dict(tr["scheduler"])},
        tr["lr"], tr["steps_per_epoch"])
    lg = cfg["stage2_model"]["matcher"]["LightGlue"].get("loss", {})
    step = make_stage2_train_step(kind, bins, H, W, tr["gt"]["pos_th"],
                                  tr["gt"]["neg_th"], lg.get("gamma", 1.0),
                                  lg.get("nll_balancing", 0.5))
    pool_np = data.stage2_pool(seeds["pool"], mix, H, W)
    pool = data.pinned(pool_np, device)
    fills = make_fills(seeds["fill"], cfg, mix, device)
    B = mix["batch"]

    def batch(i: int):
        b = data.to_device(pool[i % len(pool)], device)
        ev = {k: b[k] for k in data.EVENT_KEYS}
        ev.update(K=b["K"], depth=b["depth0"])
        return (ev, {"image": b["image"], "depth": b["depth1"]}, b["T01"],
                b["T10"])

    def run_step(i: int):
        with span("step"):
            return step(state, batch(i), fill=fills[i % len(pool)])

    # set-up: the checked steps, with their extractor outputs captured
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    params = dict(model.named_parameters())
    theta0 = {n: params[n].detach().clone() for n in names}
    captured = {"event_extractor": [], "image_extractor": []}
    hooks = []
    for side in ("event_extractor", "image_extractor"):
        def hook(m, args, out, _side=side):
            captured[_side].append({k: out[k] for k in KEEP})
        hooks.append(getattr(model, side).register_forward_hook(hook))
    counter = FlopCounter(model, lambda n: n.startswith("matcher"))
    losses, g1 = [], None
    beta1 = opt["betas"][0]
    for s in range(mix["checked_steps"]):
        info = run_step(s)
        losses.append(info["loss"])
        if s == 0:
            counter.remove()
            # AdamW's first moment after one step is (1 - beta1) g; a
            # parameter the step left without one reads a gradient of 0
            g1 = {}
            for n in names:
                m = state.optimizer.state.get(params[n], {}).get("exp_avg")
                g1[n] = (m.clone() / (1 - beta1) if m is not None
                         else torch.zeros_like(params[n]))
    for h in hooks:
        h.remove()
    theta3 = {n: params[n].detach().clone() for n in names}
    losses = [float(v) for v in losses]
    lgs = lightglue_shape(cfg["stage2_model"], B)
    flops_step = counter.frozen + 3 * (
        counter.trained + lightglue_attention_flops(
            B, lgs["N"], lgs["M"], lgs["D"], lgs["h"], lgs["layers"],
            lgs["layers"]))
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    host = []
    i = mix["checked_steps"]
    w0 = time.perf_counter()
    deadline = w0 + seconds
    while time.perf_counter() < deadline:
        h0 = time.perf_counter()
        run_step(i)
        host.append(time.perf_counter() - h0)
        i += 1
    if cuda:
        torch.cuda.synchronize()
    window_s = time.perf_counter() - w0
    steps = len(host)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    res = {
        "setup_s": setup_s,
        "e2e": {"train_pairs_per_s": steps * B / window_s,
                "setup_s": setup_s},
        "attempted": steps * B,
        "memory_peak_bytes": int(peak),
        "ctx": {"role": "train", "shape": lgs, "flops_per_batch": flops_step,
                "window_batches": steps, "window_s": window_s,
                "host_s": host, "pairs_per_batch": B},
    }
    if trace:
        handles = extractor_hooks(model)
        j = [i]

        def run_n(n):
            for _ in range(n):
                run_step(j[0])
                j[0] += 1

        res["trace"] = traced(run_n, mix["trace_warmup"],
                              mix["trace_batches"])
        for h in handles:
            h.remove()

    del model, state, pool, params
    if cuda:
        torch.cuda.empty_cache()
    res["readings"], res["failed"] = judge(
        cell, sd_ref, pool_np, fills, captured, losses, g1, theta0, theta3,
        device)
    return res


def judge(cell, sd, pool_np, fills, captured, losses, g1, theta0, theta3,
          device):
    """The reference's checked steps against the program's, and the
    extractor stage on step 1's batch."""
    import math
    import torch
    cfg = cell["config"]
    ref = common.reference_module(cell["config_name"])
    model = cfg["stage2_model"]
    steps = []
    for s in range(len(losses)):
        b = {k: torch.as_tensor(v).to(device) for k, v in pool_np[s].items()}
        steps.append({"feats0": captured["event_extractor"][s],
                      "feats1": captured["image_extractor"][s],
                      "fill": fills[s], "K": b["K"], "depth0": b["depth0"],
                      "depth1": b["depth1"], "T01": b["T01"],
                      "T10": b["T10"]})
    lg = {k: sd[k] for k in theta0}
    r_losses, r_g1, r_theta = ref.stage2_steps(model, cfg["train"], lg,
                                               steps)
    keep = compare.kept_leaves(r_g1)
    readings: Dict[str, float] = {
        "loss_gap": compare.worst(abs(p - r) / abs(r)
                                  for p, r in zip(losses, r_losses)),
        "grad_gap": compare.leaf_gap(g1, r_g1, keep),
        "update_gap": compare.median_leaf_gap(
            {k: theta3[k] - theta0[k] for k in keep},
            {k: r_theta[k] - sd[k] for k in keep}, keep),
    }
    failed = sum(0 if math.isfinite(v) else 1 for v in losses) * \
        cell["traffic"]["batch"]
    with torch.no_grad():
        b = {k: torch.as_tensor(v).to(device) for k, v in pool_np[0].items()}
        voxel, occ = ref.representation(cfg["shape"], b)
        r_ev, r_im = ref.extract_pair(model, sd, voxel, occ, b["image"])
        for side, r in (("event", r_ev), ("image", r_im)):
            prog = captured[side + "_extractor"][0]
            for k, v in compare.extractor_gaps(prog, r).items():
                readings[f"{k}.{side}"] = (compare.median(v)
                                           if isinstance(v, list) else v)
    return readings, failed
