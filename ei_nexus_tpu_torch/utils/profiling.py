"""Tracing and per-step timing.

Counterpart of `ei_nexus_tpu/utils/profiling.py`:
 - `trace(log_dir)`: `torch.profiler` over the enclosed work (the CPU and,
   where there is one, the card), written as a Chrome trace into
   `log_dir`;
 - `annotate(name)`: a named span (`torch.profiler.record_function`) that
   attributes the enclosed operators in such a trace, and costs nothing
   while no profiler records;
 - `SpanTrace`: what a profiler's events say about those spans (device
   time, launches, host time in calls that wait on the card) and about
   the card's idle gaps;
 - `StepTimer`: wall-clock per-step timing whose `toc` waits for the
   card's queued work, with rolling statistics.

The program's spans are named `ei.<layer>[.<part>]` (SPAN_PREFIX), with
constant names: `ei.repr`; `ei.extract.event` / `.image` and, inside each,
`ei.extract.nms`, `.topk`, `.describe`; `ei.match` and, inside it,
`ei.match.self`, `.cross`, `.assign`, `.filter`; the stage-2 step's
`ei.train.gt`, `.loss`, `.backward`, `.optim`.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import deque
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

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


SPAN_PREFIX = "ei."
_OFF = contextlib.nullcontext()


def annotate(name: str):
    """A named span for a trace (a context manager): while a profiler
    records, `torch.profiler.record_function(name)`, which lies in the
    trace beside the card's kernels, on their clock, and holds the
    operators and launches made inside it; else one shared no-op context,
    so that a span costs a call and a flag read when nothing records."""
    if not torch._C._autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name)


# the runtime and driver calls that launch a kernel, as the profiler names
# them
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaLaunchCooperativeKernel")
# calls that hold the host until the card (or its allocator) is done, with
# every "*Synchronize" call and a launch call longer than LONG_LAUNCH_US,
# which waited for room in a full launch queue
BLOCKING_CALLS = ("cudaMemcpy", "cudaMalloc", "cudaFree", "cudaHostAlloc")
LONG_LAUNCH_US = 50.0


def waits(name: str, us: float) -> bool:
    """Whether a runtime call of `us` microseconds waited on the card."""
    return (name.endswith("Synchronize") or name in BLOCKING_CALLS
            or (name in LAUNCH_CALLS and us > LONG_LAUNCH_US))


Span = Tuple[str, float, float]            # name, host start, end (us)


class SpanTrace:
    """The spans named with one of `prefixes` in a profiler's events
    (`prof.events()`), and the device's operations.

    A runtime call belongs to every span whose host interval holds its
    start, on any thread (the autograd engine launches a backward from
    its own thread while the step's thread sits inside
    `ei.train.backward`). A device operation belongs to the spans that
    hold the runtime call that launched it, the call with its correlation
    id (the profiler gives a kernel and its launch the same `id`); an
    operation with no such call belongs to none. `ops` are the device's
    operations without the profiler's ranges on its timeline, `busy_us`
    the length of their union and `idle` the gaps between them. Times in
    microseconds."""

    def __init__(self, events: Iterable, prefixes: Sequence[str] = (
            SPAN_PREFIX,)):
        cuda = torch.autograd.DeviceType.CUDA
        prefixes = tuple(prefixes)
        self.spans: List[Span] = []
        self.calls: List[Span] = []        # runtime and driver calls
        self.ops: List[Tuple[str, float, float, int]] = []   # + its id
        launch_at: Dict[int, float] = {}   # correlation id -> call start
        for e in events:
            name, t0, t1 = e.name, e.time_range.start, e.time_range.end
            if name.startswith("ProfilerStep"):
                continue
            if e.device_type == cuda:
                if not (getattr(e, "is_user_annotation", False)
                        or name.startswith(prefixes)):
                    self.ops.append((name, t0, t1, e.id))
            elif name.startswith("cu"):
                self.calls.append((name, t0, t1))
                launch_at[e.id] = t0
            elif name.startswith(prefixes):
                self.spans.append((name, t0, t1))
        self.ops.sort(key=lambda o: o[1])
        self.busy_us, self.idle = self._union()
        self._launched = [launch_at.get(i) for _, _, _, i in self.ops]
        self.linked = sum(t is not None for t in self._launched)
        self._op_spans = self._holders(self._launched)
        self._call_spans = self._holders([t0 for _, t0, _ in self.calls])

    def _union(self):
        busy, idle, end = 0.0, [], None
        for _, t0, t1, _ in self.ops:
            if end is None or t0 > end:
                if end is not None:
                    idle.append((end, t0))
                busy += t1 - t0
                end = t1
            elif t1 > end:
                busy += t1 - end
                end = t1
        return busy, idle

    def _holders(self, points: List[Optional[float]]) -> List[tuple]:
        """For each host time, the indices of the spans that hold it
        (none for None), innermost (shortest) first."""
        marks = []
        for i, (_, t0, t1) in enumerate(self.spans):
            marks += [(t0, 0, i), (t1, 2, i)]
        marks += [(t, 1, j) for j, t in enumerate(points) if t is not None]
        marks.sort()
        active, out = {}, [()] * len(points)
        for _, kind, i in marks:
            if kind == 0:
                active[i] = None
            elif kind == 2:
                active.pop(i, None)
            else:
                out[i] = tuple(sorted(
                    active, key=lambda k: self.spans[k][2] - self.spans[k][1]))
        return out

    def _inside(self, holders: tuple, prefix: str) -> Optional[str]:
        """The innermost of `holders` named with `prefix`, or None."""
        for i in holders:
            if self.spans[i][0].startswith(prefix):
                return self.spans[i][0]
        return None

    def launches(self, prefix: str = SPAN_PREFIX) -> int:
        """Launch calls made inside a span named with `prefix`."""
        return sum(1 for (name, _, _), h in zip(self.calls, self._call_spans)
                   if name in LAUNCH_CALLS and self._inside(h, prefix))

    def waiting(self, prefix: str = SPAN_PREFIX
                ) -> Tuple[Dict[str, float], Dict[str, float]]:
        """Host us inside spans named with `prefix` in calls that waited
        on the card (`waits`): (by call, by innermost such span)."""
        by_call: Dict[str, float] = {}
        by_span: Dict[str, float] = {}
        for (name, t0, t1), h in zip(self.calls, self._call_spans):
            span = self._inside(h, prefix)
            if span and waits(name, t1 - t0):
                by_call[name] = by_call.get(name, 0.0) + t1 - t0
                by_span[span] = by_span.get(span, 0.0) + t1 - t0
        return by_call, by_span

    def call_us(self, prefix: str = SPAN_PREFIX
                ) -> Dict[str, Tuple[int, float]]:
        """(count, host us) by call name of every runtime call made
        inside a span named with `prefix`."""
        out: Dict[str, Tuple[int, float]] = {}
        for (name, t0, t1), h in zip(self.calls, self._call_spans):
            if self._inside(h, prefix):
                n, us = out.get(name, (0, 0.0))
                out[name] = (n + 1, us + t1 - t0)
        return out

    def device_us(self, names: Sequence[str]) -> float:
        """Device us of the operations launched inside any span of
        `names`."""
        return sum(t1 - t0 for (_, t0, t1, _), h in zip(self.ops,
                                                        self._op_spans)
                   if any(self.spans[i][0] in names for i in h))

    def kernel_us(self, fragment: str, names: Sequence[str]
                  ) -> Tuple[int, float]:
        """(count, device us) of the operations whose name holds
        `fragment` launched inside any span of `names`."""
        count, us = 0, 0.0
        for (name, t0, t1, _), h in zip(self.ops, self._op_spans):
            if fragment in name and any(self.spans[i][0] in names
                                        for i in h):
                count += 1
                us += t1 - t0
        return count, us

    def table(self) -> Dict[str, Dict[str, float]]:
        """By span name: its count, host us, and the device us, launches
        and waiting host us inside it, with what its own body (not a
        nested span) launched ("self_")."""
        rows: Dict[str, Dict[str, float]] = {}

        def row(name):
            return rows.setdefault(name, dict.fromkeys(
                ("count", "host_us", "device_us", "self_device_us",
                 "launches", "self_launches", "wait_us"), 0.0))

        for name, t0, t1 in self.spans:
            r = row(name)
            r["count"] += 1
            r["host_us"] += t1 - t0
        for (_, t0, t1, _), h in zip(self.ops, self._op_spans):
            for k, i in enumerate(h):
                r = row(self.spans[i][0])
                r["device_us"] += t1 - t0
                r["self_device_us"] += (t1 - t0) * (k == 0)
        for (name, t0, t1), h in zip(self.calls, self._call_spans):
            for k, i in enumerate(h):
                r = row(self.spans[i][0])
                if name in LAUNCH_CALLS:
                    r["launches"] += 1
                    r["self_launches"] += k == 0
                if waits(name, t1 - t0):
                    r["wait_us"] += t1 - t0
        return rows

    def gap_labels(self, n: int = 10) -> List[Tuple[str, float]]:
        """The `n` longest idle gaps (label, us), each labelled by the
        innermost span that held the launch of the operation that ends
        it, or, where no launch call of that operation is in the events,
        the span that held the gap's middle."""
        ends: Dict[float, int] = {}
        for k, op in enumerate(self.ops):
            ends.setdefault(op[1], k)
        out = []
        for g0, g1 in sorted(self.idle, key=lambda g: g[0] - g[1])[:n]:
            k = ends[g1]
            h = self._op_spans[k] if self._launched[k] is not None \
                else self._holders([(g0 + g1) / 2])[0]
            out.append((self.spans[h[0]][0] if h else "outside the spans",
                        g1 - g0))
        return out


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
