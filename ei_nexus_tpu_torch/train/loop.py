"""The epoch loop the training entry points share.

`train_epochs` runs the loop of the JAX package's `train_extractor.py`
and `train_matcher.py`: the loader positioned at each epoch (and at the
preempted batch of a resumed one), batches put on the device one ahead of
the step, the status drain one step behind, the epoch-end plateau step,
checkpoints every `checkpoint_freq` epochs, `preempted` on SIGTERM or
SIGINT and `final` at the end, which records the epoch in progress when
the run stops early so that resuming from it continues the same
trajectory. The log ends with the steady rate: from the first drain to
the last (the steps up to the one enqueued at the first drain are not
counted).
"""

from __future__ import annotations

import json
import os
import signal
import time
from typing import Any, Callable, Dict, Optional

import numpy as np

from ..data import device_prefetch
from .checkpoint import save_checkpoint
from .optim import set_learning_rate


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


def train_epochs(state, loader, step: Callable[[Any, int], Dict[str, Any]],
                 put: Callable[[Any], Any], logger, tcfg: Dict[str, Any],
                 plateau, ckpt_dir: str, start_epoch: int = 0,
                 resume_skip: int = 0, max_steps: Optional[int] = None,
                 prefix: str = "train") -> int:
    """Train from `start_epoch` (skipping `resume_skip` batches of it) to
    `tcfg["epochs"]` or `max_steps`. `step(batch, i)` makes the update of
    global step i (0-based) and returns its info (0-d tensors); `put`
    makes a loader batch the step's (on a thread, one batch ahead). Saves
    the checkpoints into `ckpt_dir`; returns the global step reached."""
    shutdown = GracefulShutdown()
    global_step = state.step
    start_step = global_step
    epochs = tcfg["epochs"]
    end_epoch = epochs
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
            logger.maybe_status(pstep, vals, prefix=f"[{prefix} e{epoch}] ")
            if plateau is not None:
                epoch_losses.append(vals["loss"])

        pending = None
        for batch in device_prefetch(iter(loader), put):
            info = step(batch, global_step)
            global_step += 1
            if pending is not None:
                drain(pending)
            pending = (global_step, info)
            if shutdown.requested or (max_steps and global_step >= max_steps):
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
        if max_steps and global_step >= max_steps:
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
    return global_step


def resume_position(state, start_epoch: int, steps_per_epoch: int):
    """(epoch, batch) to continue from after restoring a checkpoint saved
    at `start_epoch` and `state.step`: the step count positions the
    stream inside the (seed + epoch keyed) epoch permutation, so a resumed
    run continues exactly."""
    skip = max(0, state.step - start_epoch * steps_per_epoch)
    return start_epoch + skip // steps_per_epoch, skip % steps_per_epoch


def load_plateau(plateau, ckpt: str) -> None:
    """Restore the plateau controller from a checkpoint's sidecar, where
    it has one."""
    sidecar = os.path.join(ckpt, "plateau.json")
    if plateau is not None and os.path.exists(sidecar):
        with open(sidecar) as f:
            plateau.load_state_dict(json.load(f))
