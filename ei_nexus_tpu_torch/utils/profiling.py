"""Tracing and per-step timing.

Counterpart of `ei_nexus_tpu/utils/profiling.py`:
 - `trace(log_dir)`: `torch.profiler` over the enclosed work (the CPU and,
   where there is one, the card), written as a Chrome trace into
   `log_dir`;
 - `annotate(name)`: a named span (`torch.profiler.record_function`) that
   attributes the enclosed operators in such a trace;
 - `StepTimer`: wall-clock per-step timing whose `toc` waits for the
   card's queued work, with rolling statistics.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import deque
from typing import Dict, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block into `log_dir`/trace.json (chrome://tracing,
    Perfetto); yields the profiler."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """A named span for a trace (usable as a context manager)."""
    return torch.profiler.record_function(name)


def _tensors(result):
    if isinstance(result, torch.Tensor):
        yield result
    elif isinstance(result, dict):
        for v in result.values():
            yield from _tensors(v)
    elif isinstance(result, (list, tuple)):
        for v in result:
            yield from _tensors(v)


class StepTimer:
    """Rolling per-step wall-clock statistics.

    Call `tic()` before the step and `toc(result)` after it: `toc` waits
    for the card's queued work (`torch.cuda.synchronize` where `result`
    holds a CUDA tensor) so that the card's time is inside the step;
    `fetch=True` also reads one of its tensors back to the host."""

    def __init__(self, window: int = 100):
        self.times = deque(maxlen=window)
        self._t0: Optional[float] = None

    def tic(self) -> None:
        self._t0 = time.perf_counter()

    def toc(self, result=None, fetch: bool = False) -> float:
        if result is not None:
            tensors = list(_tensors(result))
            if any(t.is_cuda for t in tensors):
                torch.cuda.synchronize()
            if fetch and tensors:
                tensors[0].cpu()
        dt = time.perf_counter() - (self._t0 or time.perf_counter())
        self.times.append(dt)
        self._t0 = None
        return dt

    def stats(self) -> Dict[str, float]:
        if not self.times:
            return {}
        arr = np.asarray(self.times)
        return {
            "step_time_mean_s": float(arr.mean()),
            "step_time_p50_s": float(np.percentile(arr, 50)),
            "step_time_p95_s": float(np.percentile(arr, 95)),
            "steps_per_s": float(1.0 / max(arr.mean(), 1e-9)),
        }
