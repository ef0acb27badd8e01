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
import json
import os
import signal
import time

import numpy as np
import torch


class GracefulShutdown:
    """SIGTERM/SIGINT -> finish the current step, checkpoint, exit: a flag
    the epoch loop checks each step, so a preempted job saves a resumable
    checkpoint."""

    def __init__(self):
        self.requested = False

        def handler(signum, frame):
            self.requested = True

        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                signal.signal(sig, handler)
            except ValueError:
                pass  # not the main thread


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
    from .data import DataLoader, PinnedPut, device_prefetch
    from .data.ec import fetch_ec_dataset
    from .data.mvsec import fetch_mvsec_dataset
    from .device import resolve_device
    from .losses import build_losses
    from .models import build_model
    from .models.config_adapter import eim_config_from_dict
    from .models.layers import init_parameters
    from .train import (PlateauController, create_train_state,
                        restore_checkpoint, save_checkpoint,
                        set_learning_rate)
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
    if cfg.get("superpoint_weights"):
        raise NotImplementedError(
            "superpoint_weights needs models/port_torch.py, which is not "
            "ported yet (ROADMAP Queue 1 item 6)")

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
        # exact mid-epoch resume: the step count positions the stream
        # inside the (seed + epoch keyed) epoch permutation
        resume_skip = max(0, state.step - start_epoch * steps_per_epoch)
        start_epoch += resume_skip // steps_per_epoch
        resume_skip %= steps_per_epoch
        logger.log_info(f"resumed from {args.resume} @ epoch {start_epoch}"
                        + (f" batch {resume_skip}" if resume_skip else ""))
        if plateau is not None:
            sidecar = os.path.join(args.resume, "plateau.json")
            if os.path.exists(sidecar):
                with open(sidecar) as f:
                    plateau.load_state_dict(json.load(f))

    losses = build_losses(tcfg["loss"])
    step_fn = make_stage1_train_step(losses, rep, bins, H, W)
    shutdown = GracefulShutdown()
    put = PinnedPut(dev)
    ckpt_dir = os.path.join(logger.run_dir, "checkpoints")

    # -- epoch loop --------------------------------------------------------
    global_step = state.step
    start_step = global_step
    epochs = tcfg["epochs"]
    # the epoch of the "final" checkpoint: the epoch in progress when
    # stopping early (SIGTERM, --max-steps), so resuming from it continues
    # the same trajectory
    end_epoch = epochs
    # the steady rate: from the first drain (the steps up to the one
    # enqueued then are excluded) to the last drain
    timing = {"t0": None, "step0": None, "t1": None, "step1": None}
    for epoch in range(start_epoch, epochs):
        loader.set_epoch(epoch, resume_skip if epoch == start_epoch else 0)
        t_epoch = time.time()
        epoch_losses = []

        def drain(pending):
            # read the PREVIOUS step's scalars only after the next step is
            # enqueued: the card works while the host waits for them
            pstep, pinfo = pending
            vals = {k: float(v) for k, v in pinfo.items()}
            now = time.perf_counter()
            if timing["t0"] is None:
                # called once step pstep + 1 is enqueued
                timing["t0"], timing["step0"] = now, pstep + 1
            timing["t1"], timing["step1"] = now, pstep
            logger.maybe_status(pstep, vals, prefix=f"[stage1 e{epoch}] ")
            if plateau is not None:
                epoch_losses.append(vals["loss"])

        pending = None
        batches = device_prefetch(iter(loader),
                                  lambda b: put(compact_stage1_batch(b)))
        for batch in batches:
            info = step_fn(state, batch)
            global_step += 1
            if pending is not None:
                drain(pending)
            pending = (global_step, info)
            if shutdown.requested or (
                    args.max_steps and global_step >= args.max_steps):
                break
        if pending is not None:
            drain(pending)
        logger.log_info(f"epoch {epoch} done in {time.time() - t_epoch:.1f}s")
        if plateau is not None and epoch_losses and not shutdown.requested:
            # the monitored metric is the epoch-mean training loss; skipped
            # on preemption (the epoch is partial and resuming replays it)
            new_lr = plateau.step(float(np.mean(epoch_losses)))
            set_learning_rate(state.optimizer, new_lr)
            logger.log_info(f"plateau lr -> {new_lr:.2e}")
        if not shutdown.requested and (
                (epoch + 1) % tcfg.get("checkpoint_freq", 5) == 0):
            path = save_checkpoint(ckpt_dir, state, epoch + 1)
            if plateau is not None:
                with open(os.path.join(path, "plateau.json"), "w") as f:
                    json.dump(plateau.state_dict(), f)
            logger.log_info(f"checkpoint saved: {path}")
        if shutdown.requested:
            path = save_checkpoint(ckpt_dir, state, epoch, name="preempted")
            logger.log_info(f"shutdown requested; saved {path}")
            end_epoch = epoch
            break
        if args.max_steps and global_step >= args.max_steps:
            end_epoch = epoch
            break
    path = save_checkpoint(ckpt_dir, state, end_epoch, name="final")
    logger.log_info(f"final checkpoint: {path}")
    logger.log_info(f"stopped at step {global_step}, epoch "
                    f"{end_epoch}/{epochs}")
    n = (timing["step1"] or 0) - (timing["step0"] or 0)
    if n > 0:
        secs = timing["t1"] - timing["t0"]
        logger.log_info(f"steady rate: steps {timing['step0'] + 1} to "
                        f"{timing['step1']} (of {start_step + 1} to "
                        f"{global_step}) in {secs:.3f} s, "
                        f"{n / secs:.3f} steps/s")
    logger.close()
    return state


if __name__ == "__main__":
    main()
