"""What the per-layer metric files (`metrics/<name>.py`) read. Each
function takes the run's context (the driver's `ctx` with the `trace` of
a `--trace 1` run) and the role its metric belongs to ("serve" or
"train"), and returns None where there is nothing to read: another role,
no trace, or no such range or kernel in it."""

from __future__ import annotations

from typing import Optional

from .flops import PEAK, attn_roofline


def _trace(ctx, role):
    if ctx.get("role") != role:
        return None
    return ctx.get("trace")


def host_ms(ctx, role) -> Optional[float]:
    """Mean host ms to enqueue one batch or step (no sync) in the window."""
    if ctx.get("role") != role or not ctx.get("host_s"):
        return None
    return 1e3 * sum(ctx["host_s"]) / len(ctx["host_s"])


def range_dev_ms(ctx, role, *names) -> Optional[float]:
    """Device ms a batch of the kernels launched inside the named harness
    ranges, summed."""
    tr = _trace(ctx, role)
    if tr is None:
        return None
    vals = [tr.device_ms(n) for n in names]
    if any(v is None for v in vals):
        return None
    return sum(vals)


def roofline(ctx, role) -> Optional[float]:
    tr = _trace(ctx, role)
    return None if tr is None else attn_roofline(tr, role, ctx["shape"])


def mfu(ctx, role) -> Optional[float]:
    """Model FLOPs of the window over its time, as a share (%) of the
    TF32 peak (the float32 ceiling)."""
    if ctx.get("role") != role or not ctx.get("window_s"):
        return None
    rate = ctx["flops_per_batch"] * ctx["window_batches"] / ctx["window_s"]
    return 100.0 * rate / PEAK


def device_idle(ctx, role) -> Optional[float]:
    """Share (%) of the measured window in which no device operation ran:
    1 - (the traced busy time a batch, the union of the device's operation
    intervals) x (batches in the window) / (the window's length). The
    window is the untraced one: the profiler's own host cost stretches a
    host-paced trace (a stage-2 step: 383 ms traced against 160 ms
    untraced on an H100), so the traced window's idle share would read
    the profiler."""
    tr = _trace(ctx, role)
    if tr is None or tr.batches <= 0 or not ctx.get("window_s"):
        return None
    busy = tr.busy_us / 1e6 / tr.batches * ctx["window_batches"]
    return 100.0 * (1.0 - busy / ctx["window_s"])
