"""Stage-1 training entry point: distil the event keypoint extractor
against the frozen image extractor on time-synchronised event/image pairs.

The port's counterpart of the repository's `train_extractor.py`, with its
arguments and flow: the config (`defaults:` composition, `key=value`
overrides), the logger, the dataset (MVSEC or EC, trained at the crop size
when pair augmentation is on), the sharded loader with its exact mid-epoch
resume, the model, optimizer and schedule, the compact wire and pinned
transfers, the step, the status drain one step behind, the epoch-end
plateau step, checkpoints every `checkpoint_freq` epochs, then
`preempted` (on SIGTERM/SIGINT) and `final`.

    python -m ei_nexus_tpu_torch.train_extractor \\
        --config configs/train_EIM_stage1_EC_SP_MNN.yaml \\
        [--resume RUN/checkpoints/final] [--max-steps N] [--device cuda] \\
        [key=value overrides...]

It runs on the card unless `--device` names another (`--device cpu` runs
the kernels' plain versions on the CPU); the config's `device` key is the
JAX package's and is not read.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config",
                   default="configs/train_EIM_stage1_MVSEC_SP_MNN.yaml")
    p.add_argument("--resume", default=None,
                   help="checkpoint directory to resume from")
    p.add_argument("--max-steps", type=int, default=None,
                   help="cap total steps (smoke testing)")
    p.add_argument("--device", default="cuda",
                   help="the card (default) or another torch device")
    p.add_argument("overrides", nargs="*", help="key=value config overrides")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from .data import DataLoader, PinnedPut
    from .data.ec import fetch_ec_dataset
    from .data.mvsec import fetch_mvsec_dataset
    from .device import resolve_device
    from .losses import build_losses
    from .models import build_model
    from .models.config_adapter import eim_config_from_dict
    from .models.layers import init_parameters
    from .train import (PlateauController, create_train_state,
                        restore_checkpoint)
    from .train.loop import load_plateau, resume_position, train_epochs
    from .train.partition import frozen_roots_from_config
    from .train.steps import compact_stage1_batch, make_stage1_train_step
    from .utils import load_config, logger_from_config, save_config

    dev = resolve_device(args.device)
    cfg = load_config(args.config, args.overrides)
    logger = logger_from_config(cfg, cfg.get("experiment", "stage1"))
    save_config(cfg, os.path.join(logger.run_dir, "config.yaml"))
    logger.log_info(f"device: {dev}"
                    + (f" ({torch.cuda.get_device_name(dev)})"
                       if dev.type == "cuda" else ""))
    np.random.seed(cfg.get("seed", 3407))

    # -- data --------------------------------------------------------------
    ds_cfg = cfg.dataset.to_dict()
    H, W = ds_cfg["resolution"]
    bins = ds_cfg["channel"]
    rep = ds_cfg["representation_type"]
    fetch = fetch_mvsec_dataset if ds_cfg["name"] == "mvsec" \
        else fetch_ec_dataset
    train_ds = fetch(ds_cfg, "train")
    if getattr(train_ds, "augment", None) is not None:
        # pair augmentation crops every sample to crop_size: that is the
        # training resolution (the augmentation clamps it to the frame)
        ch, cw = train_ds.augment.crop_size
        H, W = min(ch, H), min(cw, W)
        logger.log_info(f"pair augmentation active: training at {H}x{W}")
    loader = DataLoader(
        train_ds, batch_size=ds_cfg["train"]["batch_size"],
        shuffle=ds_cfg["train"].get("shuffle", True), drop_last=True,
        seed=cfg.get("seed", 0),
        num_workers=ds_cfg["train"].get("num_workers", 4))
    steps_per_epoch = max(len(loader), 1)
    logger.log_info(f"train dataset: {len(train_ds)} samples, "
                    f"{len(loader)} steps/epoch")

    # -- model -------------------------------------------------------------
    model_dict = cfg.model.to_dict()
    model_cfg = eim_config_from_dict(model_dict)
    model = build_model(model_dict.get("name", "EIM"), model_cfg,
                        device="cpu")
    # random weights drawn on the CPU from the seed, then moved
    init_parameters(model, torch.Generator().manual_seed(cfg.get("seed", 0)))
    model = model.to(dev)
    n_params = sum(p.numel() for p in model.parameters())
    logger.log_info(f"model parameters: {n_params / 1e6:.2f}M")
    # optional pretrained image-extractor weights, read only where the file
    # exists (a config naming an absent file trains on, as the JAX entry)
    sp_path = cfg.get("superpoint_weights")
    if sp_path and os.path.exists(sp_path):
        from .models.port_torch import (load_superpoint_torch_weights,
                                        load_torch_file)
        model.image_extractor.load_state_dict(
            load_superpoint_torch_weights(load_torch_file(sp_path)),
            strict=True)
        logger.log_info(f"loaded SuperPoint weights from {sp_path}")

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

    losses = build_losses(tcfg["loss"])
    step_fn = make_stage1_train_step(losses, rep, bins, H, W)
    put = PinnedPut(dev)
    train_epochs(state, loader, lambda batch, i: step_fn(state, batch),
                 lambda b: put(compact_stage1_batch(b)), logger, tcfg,
                 plateau, os.path.join(logger.run_dir, "checkpoints"),
                 start_epoch, resume_skip, args.max_steps, prefix="stage1")
    logger.close()
    return state


if __name__ == "__main__":
    main()
