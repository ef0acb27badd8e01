"""Stage-2 training entry point: train LightGlue on event/image pairs, with
ground-truth matches from pose and depth, or, for a dataset without depth
(EC), from a random homography of the frame.

The port's counterpart of the repository's `train_matcher.py`, with its
arguments and flow: the config (`defaults:` composition, `key=value` and
group overrides such as `dataset=ec`), the logger, the dataset (MVSEC or
EC at `dataset.resolution`: unlike stage 1 the grid is not clamped to the
pair augmentation's crop, so on EC the 160x160 frames are warped into the
180x240 grid), the loader with its exact mid-epoch resume, the model with
LightGlue's training heads, the stage-1 event extractor loaded where
`--stage1-ckpt` or `model.pretrain_stage1.model_path` names a checkpoint
that exists, the optimizer and schedule (the plateau controller with its
`plateau.json` sidecar), the step chosen by whether the samples carry
depth, and the epoch loop of `train/loop.py` (checkpoints, `preempted`,
`final`, the steady rate).

    python -m ei_nexus_tpu_torch.train_matcher \\
        --config configs/train_EIM_stage2.yaml \\
        [--stage1-ckpt RUN1/checkpoints/final] \\
        [--resume RUN2/checkpoints/final] [--max-steps N] \\
        [--device cuda] [key=value overrides...]

It runs on the card unless `--device` names another. The step's random
draws (the homography's corner jitter, the matcher's slot fill) come from
a generator reseeded from (seed, step) every step, so a resumed run draws
what the uninterrupted one would have. Under torchrun it trains
data-parallel as `train_extractor` does (`python -m
torch.distributed.run --standalone --nproc_per_node N -m
ei_nexus_tpu_torch.train_matcher ...`): every rank draws the global
batch's jitter and fill from the same generator and keeps its rows.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch
import torch.distributed as dist


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", default="configs/train_EIM_stage2.yaml")
    p.add_argument("--stage1-ckpt", default=None,
                   help="stage-1 checkpoint for the event extractor")
    p.add_argument("--resume", default=None,
                   help="checkpoint directory to resume from")
    p.add_argument("--max-steps", type=int, default=None,
                   help="cap total steps (smoke testing)")
    p.add_argument("--device", default="cuda",
                   help="the card (default) or another torch device")
    p.add_argument("overrides", nargs="*", help="key=value config overrides")
    return p.parse_args(argv)


def step_seed(seed: int, step: int) -> int:
    """The seed of global step `step`'s random draws."""
    return int(np.random.SeedSequence([seed, step]).generate_state(1)[0])


def main(argv=None):
    args = parse_args(argv)
    from .data import DataLoader, PinnedPut
    from .data.ec import fetch_ec_dataset
    from .data.mvsec import fetch_mvsec_dataset
    from .parallel.mesh import distributed_init, make_mesh, replicate
    from .models import build_model
    from .models.config_adapter import eim_config_from_dict
    from .models.layers import init_parameters
    from .train import (PlateauController, create_train_state,
                        load_stage1_event_extractor, restore_checkpoint)
    from .train.loop import load_plateau, resume_position, train_epochs
    from .train.partition import frozen_roots_from_config
    from .train.steps import (compact_stage2_batch,
                              compact_stage2_homography_batch,
                              make_stage2_homography_train_step,
                              make_stage2_train_step)
    from .utils import load_config, logger_from_config, save_config
    from .utils.logger import QuietLogger

    # under torchrun: one rank a process, data-parallel over all of them
    dev = distributed_init(args.device)
    mesh = make_mesh(device=dev)
    main_rank = mesh.rank == 0
    cfg = load_config(args.config, args.overrides)
    # rank 0 alone logs the run and writes its checkpoints
    logger = (logger_from_config(cfg, cfg.get("experiment", "stage2"))
              if main_rank else QuietLogger())
    ckpt_dir = os.path.join(logger.run_dir, "checkpoints") \
        if main_rank else None
    if main_rank:
        save_config(cfg, os.path.join(logger.run_dir, "config.yaml"))
    logger.log_info(f"device: {dev}"
                    + (f" ({torch.cuda.get_device_name(dev)})"
                       if dev.type == "cuda" else ""))
    if dist.is_initialized():
        # every rank says where it runs; rank 0 also logs it
        where = (f"rank {mesh.rank} of {mesh.world}: backend "
                 f"{dist.get_backend()}, device {dev}")
        print(where, flush=True)
        logger.log_info(where)
    np.random.seed(cfg.get("seed", 3407))
    seed = cfg.get("seed", 0)

    # -- data --------------------------------------------------------------
    ds_cfg = cfg.dataset.to_dict()
    H, W = ds_cfg["resolution"]
    bins = ds_cfg["channel"]
    rep = ds_cfg["representation_type"]
    fetch = fetch_mvsec_dataset if ds_cfg["name"] == "mvsec" \
        else fetch_ec_dataset
    train_ds = fetch(ds_cfg, "train")
    loader = DataLoader(
        train_ds, batch_size=ds_cfg["train"]["batch_size"],
        shuffle=ds_cfg["train"].get("shuffle", True), drop_last=True,
        seed=seed, process_index=mesh.data_index, process_count=mesh.data,
        num_workers=ds_cfg["train"].get("num_workers", 4))
    steps_per_epoch = max(len(loader), 1)
    logger.log_info(f"train dataset: {len(train_ds)} samples, "
                    f"{len(loader)} steps/epoch, grid {H}x{W}")

    # -- model -------------------------------------------------------------
    model_dict = cfg.model.to_dict()
    model_cfg = eim_config_from_dict(model_dict)
    model = build_model(model_dict.get("name", "EIM"), model_cfg,
                        device="cpu", training_heads=True)
    # random weights drawn on the CPU from the seed, then moved
    init_parameters(model, torch.Generator().manual_seed(seed))
    s1 = args.stage1_ckpt or cfg.get_path("model.pretrain_stage1.model_path")
    if s1 and os.path.exists(str(s1)):
        load_stage1_event_extractor(str(s1), model)
        logger.log_info(f"loaded stage-1 event extractor from {s1}")
    model = model.to(dev)
    n_params = sum(p.numel() for p in model.parameters())
    logger.log_info(f"model parameters: {n_params / 1e6:.2f}M")

    # -- optimizer ---------------------------------------------------------
    tcfg = cfg.train.to_dict()
    state = create_train_state(model, frozen_roots_from_config(model_cfg),
                               tcfg["optimizer"], tcfg["scheduler"],
                               tcfg["optimizer"]["lr"], steps_per_epoch)
    plateau = (PlateauController.from_config(tcfg["scheduler"],
                                             tcfg["optimizer"]["lr"])
               if state.host_lr else None)
    start_epoch = 0
    resume_skip = 0
    if args.resume:
        state, start_epoch = restore_checkpoint(args.resume, state)
        start_epoch, resume_skip = resume_position(state, start_epoch,
                                                   steps_per_epoch)
        logger.log_info(f"resumed from {args.resume} @ epoch {start_epoch}"
                        + (f" batch {resume_skip}" if resume_skip else ""))
        load_plateau(plateau, args.resume)
    # rank 0's parameters, statistics and moments on every rank; the step
    # then runs over the mesh
    replicate(state, mesh)

    # -- the step: pose + depth where the samples carry depth, else the
    # homography of the frame (EC has no depth frames)
    gtc = tcfg.get("gt_matches", {})
    lgc = model_cfg.matcher.lightglue
    kw = dict(pos_th=gtc.get("pos_th", 3.0), neg_th=gtc.get("neg_th", 5.0),
              gamma=lgc.gamma, nll_balancing=lgc.nll_balancing)
    if "depth" in train_ds[0][0]:
        step_fn = make_stage2_train_step(rep, bins, H, W, **kw)
        compact_fn = compact_stage2_batch
        logger.log_info("pose + depth supervised stage 2")
    else:
        step_fn = make_stage2_homography_train_step(rep, bins, H, W, **kw)
        compact_fn = compact_stage2_homography_batch
        logger.log_info("no depth in dataset: homography-supervised stage 2 "
                        "(on-device warp + known-H GT)")
    generator = torch.Generator(device=dev)

    def step(batch, i):
        generator.manual_seed(step_seed(seed, i))
        return step_fn(state, batch, generator)

    put = PinnedPut(dev)
    train_epochs(state, loader, step, lambda b: put(compact_fn(b)), logger,
                 tcfg, plateau, ckpt_dir, start_epoch, resume_skip,
                 args.max_steps, prefix="stage2")
    logger.close()
    if dist.is_initialized():
        dist.destroy_process_group()
    return state


if __name__ == "__main__":
    main()
