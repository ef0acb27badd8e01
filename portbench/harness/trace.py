"""The traced stretch of a `--trace 1` run and what is read from it.

`traced` runs a driver's loop under `torch.profiler`: a warm-up cycle,
then the active cycle, with a pause at its edges (the profiler has lost
kernel events at a trace's start; the guard of `chip_smoke.py`'s
`trace_events` / `trace_gaps`, copied here). A trace with fewer kernel
events than launch calls is taken again, three times at most, and the
run fails if none is whole. `Trace` holds what the metric readers read:
the device's operations with their intervals, the harness's host ranges
with the device time of the kernels they launched, the busy union and
the traced window (first device operation to last, the pauses left out).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

# the runtime and driver calls that launch a kernel, as the profiler names
# them (chip_smoke.py)
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaLaunchCooperativeKernel")
SPAN = "portbench."        # prefix of the harness's own host ranges


def span(name: str):
    """A host range of the harness (a no-op while nothing profiles)."""
    import torch
    return torch.profiler.record_function(SPAN + name)


class Trace:
    def __init__(self, events, batches: int):
        import torch
        cuda = torch.autograd.DeviceType.CUDA
        self.batches = batches          # batches or steps in the trace
        self.ops: List[Tuple[str, float, float]] = []   # (name, t0, t1) us
        self.ranges: Dict[str, List[float]] = {}        # name -> device us
        self.host: List[Tuple[str, float, float]] = []  # harness ranges
        launches = 0
        for e in events:
            name = e.name
            if name.startswith("ProfilerStep"):
                continue
            on_device = e.device_type == cuda
            if on_device:
                if name.startswith(SPAN) or getattr(e, "is_user_annotation",
                                                    False):
                    continue
                self.ops.append((name, e.time_range.start,
                                 e.time_range.end))
            elif name in LAUNCH_CALLS:
                launches += 1
            elif name.startswith(SPAN):
                self.ranges.setdefault(name[len(SPAN):], []).append(
                    e.device_time_total)
                self.host.append((name[len(SPAN):], e.time_range.start,
                                  e.time_range.end))
        kernels = sum(1 for n, _, _ in self.ops
                      if not n.startswith(("Memcpy", "Memset")))
        self.gaps = ([f"{kernels} kernel events for {launches} launches"]
                     if kernels < launches else [])
        self.ops.sort(key=lambda o: o[1])
        self.busy_us, self.idle = self._union()
        self.window_us = ((self.ops[-1][2] - self.ops[0][1])
                          if self.ops else 0.0)

    def _union(self):
        busy, idle = 0.0, []
        end = None
        for _, t0, t1 in self.ops:
            if end is None or t0 > end:
                if end is not None:
                    idle.append((end, t0))
                busy += t1 - t0
                end = t1
            elif t1 > end:
                busy += t1 - end
                end = t1
        return busy, idle

    def device_ms(self, range_name: str) -> Optional[float]:
        """Mean device ms of the kernels one occurrence of a harness range
        launched, per batch; None where the range never ran."""
        us = self.ranges.get(range_name)
        if not us or self.batches <= 0:
            return None
        return sum(us) / 1e3 / self.batches

    def op_seconds(self, fragments) -> Tuple[float, Dict[str, int]]:
        """(device seconds, calls by fragment) of the operations whose name
        holds one of `fragments`."""
        secs, calls = 0.0, {}
        for name, t0, t1 in self.ops:
            for frag in fragments:
                if frag in name:
                    secs += (t1 - t0) / 1e6
                    calls[frag] = calls.get(frag, 0) + 1
                    break
        return secs, calls

    def breakdown(self, n: int = 10) -> dict:
        """The device operations that took most time, by name, and the
        longest idle gaps, by the innermost harness range the host was in
        at the gap's middle."""
        by_name: Dict[str, float] = {}
        for name, t0, t1 in self.ops:
            by_name[name] = by_name.get(name, 0.0) + (t1 - t0) / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        gaps = []
        for g0, g1 in sorted(self.idle, key=lambda g: g[0] - g[1])[:n]:
            mid = (g0 + g1) / 2
            inner = [h for h in self.host if h[1] <= mid <= h[2]]
            label = (min(inner, key=lambda h: h[2] - h[1])[0] if inner
                     else "outside the harness's ranges")
            gaps.append([label, (g1 - g0) / 1e6])
        return {"device_ops": [[k[:160], v] for k, v in ops],
                "idle_gaps": gaps}


def traced(run: Callable[[int], None], warm: int, active: int,
           pause: float = 0.05, tries: int = 3) -> Trace:
    """Trace `run(active)` after `run(warm)` in a warm-up cycle."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    found = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1)) as prof:
            run(warm)
            torch.cuda.synchronize()
            prof.step()
            time.sleep(pause)
            run(active)
            torch.cuda.synchronize()
            time.sleep(pause)
        trace = Trace(prof.events(), active)
        if not trace.gaps and trace.ops:
            return trace
        found += trace.gaps or ["no device operation"]
    raise RuntimeError(f"{tries} traces lost events: " + "; ".join(found))
