"""The plain reference of an EIM configuration (event extractor, frozen
image extractor, LightGlue), built from the configuration file's model
dict: what `nets` computes, wired as the served forward and the stage-2
step wire it. Imports nothing of the program."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from . import nets


def lightglue_cfg(model: dict) -> dict:
    lg = model["matcher"].get("LightGlue", {})
    return {"input_dim": lg.get("input_dim", 256),
            "descriptor_dim": lg.get("descriptor_dim", 256),
            "n_layers": lg.get("n_layers", 9),
            "num_heads": lg.get("num_heads", 4),
            "filter_threshold": lg.get("filter_threshold", 0.0)}


def representation(shape: dict, batch: Dict[str, torch.Tensor]):
    """(voxel grid NHWC, occupancy) of a batch's padded events."""
    ev = [batch[k].float() for k in ("events_x", "events_y", "events_t",
                                     "events_p")]
    valid = batch["events_valid"].bool()
    H, W = shape["height"], shape["width"]
    return (nets.voxel_grid(*ev, valid, shape["bins"], H, W),
            nets.occupancy(ev[0], ev[1], valid, H, W))


def extract_pair(model: dict, sd, voxel, occupancy, image):
    """Both extractors' outputs (`nets.extract`): events under the
    occupancy mask, the frame without one."""
    ev = nets.extract(sd, "event_extractor",
                      nets.extractor_spec(model["event_extractor"]), voxel,
                      occupancy)
    im = nets.extract(sd, "image_extractor",
                      nets.extractor_spec(model["image_extractor"]), image)
    return ev, im


def match(model: dict, sd, feats0: dict, feats1: dict):
    """(log assignment, matches0) of LightGlue over two sides' slots
    (`sparse_positions`, `sparse_descriptors`, `sparse_valid`,
    `image_size`), fitted to `max_points_num`."""
    L = model["matcher"].get("max_points_num", 1024)
    cfg = lightglue_cfg(model)
    s0 = nets.fit_slots(feats0["sparse_positions"].float(),
                        feats0["sparse_descriptors"].float(),
                        feats0["sparse_valid"], L)
    s1 = nets.fit_slots(feats1["sparse_positions"].float(),
                        feats1["sparse_descriptors"].float(),
                        feats1["sparse_valid"], L)
    la = nets.lightglue(sd, cfg, s0[0][..., :2], s1[0][..., :2], s0[1],
                        s1[1], s0[2], s1[2], feats0["image_size"].float(),
                        feats1["image_size"].float())
    return la, nets.filter_matches(la, s0[2], s1[2],
                                   cfg["filter_threshold"]), s0[2], s1[2]


def stage2_steps(model: dict, train: dict, params: Dict[str, torch.Tensor],
                 steps: List[dict]) -> Tuple[List[float], dict, dict]:
    """Stage 2's first steps from `params` (LightGlue's leaves, float32):
    each step fits the slots with its random fill, runs LightGlue with
    every head, labels the ground truth from pose and depth, takes the
    deep-supervision loss, its gradient, and one AdamW update at the
    schedule's rate. `steps` hold each step's extractor outputs
    (`feats0`, `feats1`), its `fill` ((positions, descriptors) per side)
    and its `K`, `depth0`, `depth1`, `T01`, `T10`.
    Returns (losses, the first step's gradients, the parameters after the
    last step)."""
    cfg = lightglue_cfg(model)
    lg = model["matcher"].get("LightGlue", {})
    loss_cfg = lg.get("loss", {})
    L = model["matcher"].get("max_points_num", 1024)
    opt_cfg = train["optimizer"]
    sched = train["scheduler"]
    p = {k: v.detach().clone().float() for k, v in params.items()}
    opt = nets.AdamW(p, tuple(opt_cfg["betas"]), opt_cfg["eps"],
                     opt_cfg["weight_decay"])
    losses, first = [], None
    for i, s in enumerate(steps):
        leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        f0, f1 = s["feats0"], s["feats1"]
        s0 = nets.fit_slots(f0["sparse_positions"].float(),
                            f0["sparse_descriptors"].float(),
                            f0["sparse_valid"], L, s["fill"][0])
        s1 = nets.fit_slots(f1["sparse_positions"].float(),
                            f1["sparse_descriptors"].float(),
                            f1["sparse_valid"], L, s["fill"][1])
        all_la, c0, c1 = nets.lightglue(
            leaves, cfg, s0[0][..., :2], s1[0][..., :2], s0[1], s1[1],
            s0[2], s1[2], f0["image_size"].float(), f1["image_size"].float(),
            training=True)
        with torch.no_grad():
            assign, m0, m1 = nets.gt_matches(
                s0[0][..., :2], s1[0][..., :2], s["K"], s["K"], s["depth0"],
                s["depth1"], s["T01"], s["T10"], train["gt"]["pos_th"],
                train["gt"]["neg_th"])
        loss = nets.matcher_loss(all_la, c0, c1, assign, m0, m1,
                                 loss_cfg.get("gamma", 1.0),
                                 loss_cfg.get("nll_balancing", 0.5))
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
        g = {k: (gr if gr is not None else torch.zeros_like(leaves[k]))
             for k, gr in zip(leaves, grads)}
        if first is None:
            first = {k: v.detach().clone() for k, v in g.items()}
        lr = nets.cosine_lr(i, train["lr"], sched["eta_min"],
                            sched["T_max"], train["steps_per_epoch"])
        opt.step(g, lr)
        losses.append(float(loss.detach()))
    return losses, first, p
