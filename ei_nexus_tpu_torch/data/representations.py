"""Event-stream -> dense tensor representations.

Counterpart of `ei_nexus_tpu/data/representations.py`: the voxel grid,
the time surface, the event stack, the distance map and the event-count
image, and `build_representation`, which picks one by name. Events arrive
as fixed-length padded arrays (x, y, t, p) with a validity mask; the
batch is a leading dimension written out (B, N) rather than a vmap.
Scatter-adds are `index_add_`: sequential in event order on the CPU, so
the voxel grid's sums match the JAX package's scatter there; atomic on
the card, so they may differ in their last bits. The other
representations are exact on both: maxima, and sums of integers.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def normalize_time(t: torch.Tensor, mask: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """Normalize (B, N) timestamps to [0, 1] over each row's valid window
    (t -= t0; t /= t_last + 1e-8, t0/t_last the first/last valid stamps)."""
    if mask is None:
        t0 = t[..., :1]
        t_last = t[..., -1:] - t0
    else:
        t0 = torch.where(mask, t, torch.inf).amin(dim=-1, keepdim=True)
        t0 = torch.where(torch.isfinite(t0), t0, torch.zeros_like(t0))
        t_last = torch.where(mask, t - t0, torch.zeros_like(t)).amax(
            dim=-1, keepdim=True)
    return (t - t0) / (t_last + 1e-8)


def _nonzero_normalize(grid: torch.Tensor) -> torch.Tensor:
    """Standardize each sample's nonzero entries (mean 0, unbiased std 1)."""
    g = grid.reshape(grid.shape[0], -1)
    nz = g != 0
    cnt = nz.sum(dim=1, keepdim=True)
    safe_cnt = cnt.clamp(min=1)
    zero = torch.zeros_like(g)
    mean = torch.where(nz, g, zero).sum(dim=1, keepdim=True) / safe_cnt
    var = (torch.where(nz, (g - mean) ** 2, zero).sum(dim=1, keepdim=True)
           / (safe_cnt - 1).clamp(min=1))
    std = torch.sqrt(var)
    centered = torch.where(nz, g - mean, g)
    standardized = torch.where(
        std > 0, centered / torch.where(std > 0, std, torch.ones_like(std)),
        centered)
    return torch.where(cnt > 0, standardized, g).reshape(grid.shape)


def events_to_voxel_grid(x: torch.Tensor, y: torch.Tensor, t: torch.Tensor,
                         p: torch.Tensor, *, bins: int, height: int,
                         width: int, mask: Optional[torch.Tensor] = None,
                         normalize: bool = True) -> torch.Tensor:
    """Trilinear event splatting of (B, N) events into (B, bins, H, W).

    Polarity maps to {-1, +1} (p < 1 becomes -1); each event deposits
    value * trilinear weights onto its 8 surrounding (t, y, x) corners, in
    the JAX package's order of the 8 corner passes."""
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    p = p.to(torch.float32)
    if mask is None:
        mask = torch.ones_like(x, dtype=torch.bool)
    B = x.shape[0]
    tn = normalize_time(t.to(torch.float32), mask)
    t_scaled = (bins - 1) * tn

    x0 = x.to(torch.int64)
    y0 = y.to(torch.int64)
    t0 = t_scaled.to(torch.int64)
    value = torch.where(p < 1, -1.0, 1.0)

    size = bins * height * width
    base = (torch.arange(B, device=x.device) * size)[:, None]
    grid = torch.zeros(B * size, dtype=torch.float32, device=x.device)
    for dx in (0, 1):
        for dy in (0, 1):
            for dt in (0, 1):
                xl, yl, tl = x0 + dx, y0 + dy, t0 + dt
                inb = ((xl >= 0) & (xl < width) & (yl >= 0) & (yl < height)
                       & (tl >= 0) & (tl < bins) & mask)
                w = (value
                     * (1.0 - torch.abs(xl.to(torch.float32) - x))
                     * (1.0 - torch.abs(yl.to(torch.float32) - y))
                     * (1.0 - torch.abs(tl.to(torch.float32) - t_scaled)))
                idx = (tl * height + yl) * width + xl
                # masked slots add 0 to their sample's voxel 0, as in JAX
                idx = torch.where(inb, idx, 0) + base
                w = torch.where(inb, w, 0.0)
                grid.index_add_(0, idx.reshape(-1), w.reshape(-1))

    grid = grid.reshape(B, bins, height, width)
    if normalize:
        grid = _nonzero_normalize(grid)
    return grid


def _bin_mask(tn: torch.Tensor, b: int, dt_bin: float) -> torch.Tensor:
    """Closed bin membership [b*dt, (b+1)*dt] of normalised stamps (an
    event on an edge lands in both bins), the edges rounded to float32 as
    the JAX package's weakly typed comparison rounds them."""
    lo = float(np.float32(b * dt_bin))
    hi = float(np.float32((b + 1) * dt_bin))
    return (tn >= lo) & (tn <= hi)


def _event_pixels(x: torch.Tensor, y: torch.Tensor, t: torch.Tensor,
                  mask: Optional[torch.Tensor], height: int, width: int):
    """(normalised stamps, integer x, integer y, in-frame and valid)."""
    if mask is None:
        mask = torch.ones_like(x, dtype=torch.bool)
    tn = normalize_time(t.to(torch.float32), mask)
    xi = x.to(torch.int64)
    yi = y.to(torch.int64)
    inb = (xi >= 0) & (xi < width) & (yi >= 0) & (yi < height) & mask
    return tn, xi, yi, inb


def events_to_time_surface(x: torch.Tensor, y: torch.Tensor,
                           t: torch.Tensor, p: torch.Tensor, *, bins: int,
                           height: int, width: int,
                           mask: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Per-polarity time surfaces (B, bins, H, W): channel 2*b + p holds
    the latest normalised stamp of each pixel within time bin b of
    bins // 2, by a scatter-max over closed bin intervals; out-of-bin
    slots write -inf to index 0, and the result is clamped at 0.

    Index semantics follow JAX's scatter: a negative channel index (p < 0)
    wraps once around the sample's flat map and an index beyond it is
    dropped."""
    n_bins = bins // 2
    tn, xi, yi, inb = _event_pixels(x, y, t, mask, height, width)
    pi = p.to(torch.int64)
    B = x.shape[0]
    size = bins * height * width
    base = (torch.arange(B, device=x.device) * size)[:, None]
    surface = torch.zeros(B * size, dtype=torch.float32, device=x.device)
    neg_inf = torch.full_like(tn, -torch.inf)
    dt_bin = 1.0 / n_bins
    for b in range(n_bins):
        in_bin = inb & _bin_mask(tn, b, dt_bin)
        idx = torch.where(in_bin, ((2 * b + pi) * height + yi) * width + xi,
                          0)
        idx = torch.where((idx < 0) & (idx >= -size), idx + size, idx)
        keep = (idx >= 0) & (idx < size)
        val = torch.where(in_bin & keep, tn, neg_inf)
        idx = torch.where(keep, idx, 0) + base
        surface.scatter_reduce_(0, idx.reshape(-1), val.reshape(-1), "amax")
    surface = surface.clamp(min=0.0)    # untouched pixels stay 0
    return surface.reshape(B, bins, height, width)


def events_to_event_stack(x: torch.Tensor, y: torch.Tensor,
                          t: torch.Tensor, p: torch.Tensor, *, bins: int,
                          height: int, width: int,
                          mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Signed event counts per time bin (B, bins, H, W): stack[b, y, x] +=
    2p - 1 over closed bin intervals (the time surface's membership)."""
    tn, xi, yi, inb = _event_pixels(x, y, t, mask, height, width)
    val = 2.0 * p.to(torch.float32) - 1.0
    B = x.shape[0]
    size = bins * height * width
    base = (torch.arange(B, device=x.device) * size)[:, None]
    stack = torch.zeros(B * size, dtype=torch.float32, device=x.device)
    dt_bin = 1.0 / bins
    for b in range(bins):
        in_bin = inb & _bin_mask(tn, b, dt_bin)
        idx = torch.where(in_bin, (b * height + yi) * width + xi, 0) + base
        stack.index_add_(0, idx.reshape(-1),
                         torch.where(in_bin, val, 0.0).reshape(-1))
    return stack.reshape(B, bins, height, width)


# OpenCV's DIST_L2 3x3 chamfer weights (cv2.distanceTransform(DIST_L2, 3))
CHAMFER_A, CHAMFER_B = 0.955, 1.3693


def events_to_distance_map(x: torch.Tensor, y: torch.Tensor,
                           t: torch.Tensor, p: torch.Tensor, *, bins: int,
                           height: int, width: int,
                           mask: Optional[torch.Tensor] = None,
                           n_iter: Optional[int] = None) -> torch.Tensor:
    """Per-bin chamfer distance transform of the event occupancy
    (B, bins, H, W): occupied pixels 0, the rest 1e9, then `n_iter`
    (default max(H, W)) min-plus relaxations over the 3x3 neighbourhood
    with weights 0.955 (edge) and 1.3693 (corner), every (B*bins) map at
    once in each; distances >= 1e8 (no event in reach) become 0. Min is
    exact and each candidate one float32 add, so the result is the JAX
    package's bit for bit."""
    del p
    tn, xi, yi, inb = _event_pixels(x, y, t, mask, height, width)
    if n_iter is None:
        n_iter = max(height, width)
    B = x.shape[0]
    hw = height * width
    base = (torch.arange(B, device=x.device) * hw)[:, None]
    big = 1e9
    maps = []
    dt_bin = 1.0 / bins
    for b in range(bins):
        in_bin = inb & _bin_mask(tn, b, dt_bin)
        occ = torch.zeros(B * hw, dtype=torch.float32, device=x.device)
        occ.scatter_reduce_(
            0, (torch.where(in_bin, yi * width + xi, 0) + base).reshape(-1),
            in_bin.to(torch.float32).reshape(-1), "amax")
        maps.append(occ.reshape(B, height, width))
    occ = torch.stack(maps, dim=1).reshape(B * bins, height, width)
    dist = torch.where(occ > 0, 0.0, big)
    for _ in range(n_iter):
        dp = torch.nn.functional.pad(dist, (1, 1, 1, 1), value=big)
        cand = dist
        for dy, dx, w in ((0, 1, CHAMFER_A), (2, 1, CHAMFER_A),
                          (1, 0, CHAMFER_A), (1, 2, CHAMFER_A),
                          (0, 0, CHAMFER_B), (0, 2, CHAMFER_B),
                          (2, 0, CHAMFER_B), (2, 2, CHAMFER_B)):
            cand = torch.minimum(
                cand, dp[:, dy:dy + height, dx:dx + width] + w)
        dist = cand
    dist = torch.where(dist >= 1e8, 0.0, dist)
    return dist.reshape(B, bins, height, width)


def events_to_accumulation_image(x: torch.Tensor, y: torch.Tensor, *,
                                 height: int, width: int,
                                 mask: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """(B, N) events -> (B, H, W) event-count image."""
    xi = x.to(torch.int64)
    yi = y.to(torch.int64)
    inb = (xi >= 0) & (xi < width) & (yi >= 0) & (yi < height)
    if mask is not None:
        inb = inb & mask
    B = x.shape[0]
    base = (torch.arange(B, device=x.device) * (height * width))[:, None]
    idx = torch.where(inb, yi * width + xi, 0) + base
    img = torch.zeros(B * height * width, dtype=torch.float32,
                      device=x.device)
    img.index_add_(0, idx.reshape(-1), inb.to(torch.float32).reshape(-1))
    return img.reshape(B, height, width)


def _accumulation_representation(x, y, t, p, *, bins, height, width,
                                 mask=None):
    """The event-count image as a 1-channel representation (B, 1, H, W):
    raw counts, `bins` ignored (the ImageImageMatcher baselines on the
    accumulation frame)."""
    del t, p, bins
    return events_to_accumulation_image(x, y, height=height, width=width,
                                        mask=mask)[:, None]


_CONVERTERS = {
    "VoxelGrid": events_to_voxel_grid,
    "TimeSurface": events_to_time_surface,
    "EventStack": events_to_event_stack,
    "DistanceMap": events_to_distance_map,
    "AccumulationImage": _accumulation_representation,
}


def build_representation(kind: str, x: torch.Tensor, y: torch.Tensor,
                         t: torch.Tensor, p: torch.Tensor, *, bins: int,
                         height: int, width: int,
                         mask: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Dispatch by representation name (config `representation_type`):
    (B, N) events -> (B, C, H, W)."""
    if kind not in _CONVERTERS:
        raise ValueError(f"unknown representation {kind!r}; "
                         f"choose from {sorted(_CONVERTERS)}")
    return _CONVERTERS[kind](x, y, t, p, bins=bins, height=height,
                             width=width, mask=mask)


def pad_events(x: np.ndarray, y: np.ndarray, t: np.ndarray, p: np.ndarray,
               length: int) -> Tuple[np.ndarray, ...]:
    """Pad/truncate an event window to a fixed length + validity mask.
    Truncation keeps the most recent events."""
    n = len(x)
    if n > length:
        sl = slice(n - length, n)
        x, y, t, p = x[sl], y[sl], t[sl], p[sl]
        n = length
    out = []
    for arr in (x, y, t, p):
        buf = np.zeros(length, dtype=np.asarray(arr).dtype)
        buf[:n] = arr
        out.append(buf)
    valid = np.zeros(length, dtype=bool)
    valid[:n] = True
    return (*out, valid)
