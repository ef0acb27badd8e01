"""Run logger: timestamped run dir, TensorBoard + file log + console,
running-average status flushes, config snapshot and source backup.

A copy of `ei_nexus_tpu/utils/logger.py` (host code): TensorBoard where
it imports, and a machine-readable `metrics.jsonl` stream in the run dir
(one `{"step": N, ...scalars}` line per write). Unlike the original, each
run directory has its own `logging` logger and `close()` closes its
handlers, so two runs in one process and one second do not share a log;
the original's options that no caller sets (an extra sink, TensorBoard and
the jsonl stream switched off) are left out.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import time
from collections import defaultdict
from typing import Dict, Iterable, Optional


class Logger:
    def __init__(self, exp_name: str, output_dir: str = "runs",
                 status_freq: int = 50,
                 backup_paths: Optional[Iterable[str]] = None):
        stamp = time.strftime("%Y%m%d-%H%M%S")
        self.run_dir = os.path.join(output_dir, f"{stamp}_{exp_name}")
        os.makedirs(self.run_dir, exist_ok=True)
        os.makedirs(os.path.join(self.run_dir, "checkpoints"), exist_ok=True)
        self.status_freq = status_freq
        self._jsonl = open(os.path.join(self.run_dir, "metrics.jsonl"),
                           "a", buffering=1)

        # one logger a run directory, its handlers removed by close()
        self._logger = logging.getLogger(f"ei_nexus.{self.run_dir}")
        self._logger.setLevel(logging.INFO)
        self._logger.propagate = False
        fh = logging.FileHandler(os.path.join(self.run_dir, "log.txt"))
        fh.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s %(message)s"))
        self._logger.addHandler(fh)
        sh = logging.StreamHandler()
        sh.setFormatter(logging.Formatter("%(message)s"))
        self._logger.addHandler(sh)

        self.tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
            self.tb = SummaryWriter(log_dir=self.run_dir)
        except ImportError:
            self._logger.warning("tensorboard unavailable; file/console "
                                 "logging only")

        # source backup (reference utils/logger.py:38-44)
        if backup_paths:
            backup_dir = os.path.join(self.run_dir, "backup")
            os.makedirs(backup_dir, exist_ok=True)
            for p in backup_paths:
                if os.path.isdir(p):
                    shutil.copytree(
                        p, os.path.join(backup_dir, os.path.basename(p)),
                        dirs_exist_ok=True)
                elif os.path.isfile(p):
                    shutil.copy2(p, backup_dir)

        self._running: Dict[str, float] = defaultdict(float)
        self._counts: Dict[str, int] = defaultdict(int)

    # -- plain messages ----------------------------------------------------
    def log_info(self, msg: str) -> None:
        self._logger.info(msg)

    # -- scalar metrics ----------------------------------------------------
    def write_scalars(self, scalars: Dict[str, float], step: int) -> None:
        if self.tb is not None:
            for k, v in scalars.items():
                self.tb.add_scalar(k, float(v), step)
        if self._jsonl is not None:
            self._jsonl.write(json.dumps(
                {"step": step, **{k: float(v) for k, v in scalars.items()}})
                + "\n")

    def accumulate_status(self, scalars: Dict[str, float]) -> None:
        for k, v in scalars.items():
            self._running[k] += float(v)
            self._counts[k] += 1

    def write_status(self, step: int, prefix: str = "") -> None:
        """Flush running means every `status_freq` accumulations."""
        if not self._running:
            return
        means = {k: self._running[k] / max(self._counts[k], 1)
                 for k in self._running}
        parts = " ".join(f"{k}={v:.4g}" for k, v in means.items())
        self.log_info(f"{prefix}step {step}: {parts}")
        self.write_scalars(means, step)
        self._running.clear()
        self._counts.clear()

    def maybe_status(self, step: int, scalars: Dict[str, float],
                     prefix: str = "") -> None:
        self.accumulate_status(scalars)
        if step % self.status_freq == 0:
            self.write_status(step, prefix)

    def close(self) -> None:
        if self.tb is not None:
            self.tb.close()
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None
        for h in list(self._logger.handlers):
            self._logger.removeHandler(h)
            h.close()


class QuietLogger:
    """The logger of a training rank other than 0: it keeps and prints
    nothing (rank 0's Logger records the run)."""

    run_dir = None

    def log_info(self, msg: str) -> None:
        pass

    def maybe_status(self, step: int, scalars: Dict[str, float],
                     prefix: str = "") -> None:
        pass

    def close(self) -> None:
        pass


def logger_from_config(cfg, exp_name: str) -> Logger:
    """Build a Logger from a run config's optional `logger:` section
    (reference configs/defaults.yaml:5-8: status_freq, files_to_backup,
    dirs_to_backup). Falls back to a top-level `status_freq` for older
    configs."""
    lcfg = cfg.get("logger") or {}
    backups = list(lcfg.get("files_to_backup") or []) + \
        list(lcfg.get("dirs_to_backup") or [])
    return Logger(
        exp_name,
        output_dir=lcfg.get("output_dir", "runs"),
        status_freq=lcfg.get("status_freq", cfg.get("status_freq", 50)),
        backup_paths=[p for p in backups if os.path.exists(p)] or None)
