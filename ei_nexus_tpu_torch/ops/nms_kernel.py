"""Kernel C: fixed-round iterative NMS.

Counterpart of `ei_nexus_tpu/ops/pallas_nms.py`. `nms_rounds` launches the
hand-written CUDA kernel (csrc/nms.cu) on a CUDA tensor and runs the plain
PyTorch version `nms_rounds_plain` on a CPU tensor. Semantics of both:
`n_iter` fixed suppression rounds, no early exit; each round takes the
(2r+1)^2 window max with -inf outside the map, marks
`is_max = (x == pooled) & (x > 0)` and zeroes every non-max within r of a
max. Only max, compare and select, so the two agree bit for bit.

The kernel runs each map in one thread-block cluster of 8 blocks, the map
held in the cluster's shared memory for all rounds; `nms_plan` (pure
Python) decides the rows a block holds, and cuts a map that one cluster
cannot hold into tiles, row strips and, where its rows are too wide,
column strips, with ghost rows and columns on each side.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from .cuda_build import check, dtype_code, library

# the most dynamic shared memory one block may use on Hopper
_MAX_SMEM = 232448
# what csrc/nms.cu compiles: clusters of 8 blocks (the portable maximum),
# radii 1..8, tables of up to 128 row and column strips together, and a
# grid of at most 65535 maps
CLUSTER = 8
MAX_RADIUS = 8
MAX_STRIPS = 128
MAX_MAPS = 65535


def window_max(x: torch.Tensor, radius: int) -> torch.Tensor:
    """Same-size (2r+1)^2 max over the last two axes of (B, H, W), -inf
    outside the map (max_pool2d's implicit padding)."""
    k = 2 * radius + 1
    return F.max_pool2d(x[:, None], k, stride=1, padding=radius)[:, 0]


def nms_rounds_plain(score: torch.Tensor, radius: int,
                     n_iter: int = 4) -> torch.Tensor:
    """Plain PyTorch version of kernel C on a (B, H, W) score map."""
    x = score
    for _ in range(n_iter):
        is_max = (x == window_max(x, radius)) & (x > 0)
        neigh = window_max(is_max.to(x.dtype), radius) > 0
        x = torch.where(neigh & ~is_max, torch.zeros_like(x), x)
    return x


@dataclasses.dataclass(frozen=True)
class NmsPlan:
    """How kernel C runs a (B, H, W) call: each map cut into tiles, row
    strip by column strip, one cluster of `cluster` blocks a tile; a block
    holds `rows` consecutive rows of its tile's loaded rows (the last
    blocks of a tile may hold fewer, or none), `width` columns at most.
    `row_strips` and `col_strips` hold each strip's (own0, own1, load0,
    load1): a tile writes its own rows and columns and loads [load0,
    load1), `ghost` beyond its own on each side where the map was cut,
    clipped at the map's edges. `smem_bytes`: a block's shared memory."""
    cluster: int
    rows: int
    width: int
    ghost: int
    row_strips: Tuple[Tuple[int, int, int, int], ...]
    col_strips: Tuple[Tuple[int, int, int, int], ...]
    smem_bytes: int


def smem_bytes(rows: int, W: int, element_size: int, radius: int) -> int:
    """Shared memory of a block holding `rows` rows of W columns at `radius`
    (as csrc/nms.cu `nms_smem_bytes`): the map and its row pass, with
    `radius` halo rows on each side, in the storage type, rounded up to 16
    bytes; then the zero and is_max bits, 32 pixels to a word, for its rows
    and the dilated bits with the halo rows."""
    pixels = -(-element_size * W * (2 * rows + 2 * radius) // 16) * 16
    return pixels + 4 * ((W + 31) // 32) * (3 * rows + 2 * radius)


def _cluster_rows(W: int, element_size: int, radius: int, smem: int) -> int:
    """Rows of W columns that a cluster holds within `smem` a block."""
    lo, hi = 0, smem
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if smem_bytes(mid, W, element_size, radius) <= smem:
            lo = mid
        else:
            hi = mid - 1
    return CLUSTER * lo


def _cut(n: int, capacity: int, ghost: int):
    """n rows (or columns) as strips (own0, own1, load0, load1) that each
    load at most `capacity`, `ghost` beyond their own on each side, clipped
    at the edges; None where a strip would own none."""
    if n <= capacity:
        return ((0, n, 0, n),)
    strips, own0 = [], 0
    while own0 < n:
        load0 = max(0, own0 - ghost)
        own1 = n if load0 + capacity >= n else load0 + capacity - ghost
        if own1 <= own0:
            return None
        strips.append((own0, own1, load0, min(n, own1 + ghost)))
        own0 = own1
    return tuple(strips)


@functools.lru_cache(maxsize=64)
def nms_plan(B: int, H: int, W: int, radius: int, n_iter: int,
             element_size: int, smem: int = _MAX_SMEM) -> NmsPlan:
    """Kernel C's plan for a (B, H, W) map of `element_size`-byte elements,
    `smem` bytes of shared memory a block.

    A map that one cluster holds is one tile with no ghost rows. A larger
    one is cut into tiles that each load 2 * n_iter * radius ghost rows
    and columns beyond their own on each side where it was cut (a value
    after n rounds depends only on inputs that far away), clipped at the
    map's edges. Its columns are cut only where its rows are too wide: a
    tile is the widest whose cluster holds as many rows as it has columns,
    or the whole map's height. A block's column window reads its halo rows
    from whichever rank holds them, so fewer rows a block than the radius
    walks further ranks.

    Raises ValueError where the kernel cannot run the call: a radius it
    does not compile (1..8), a cut map whose tiles would own nothing
    beyond their ghost rows and columns (a cut map's tiles are about 440
    pixels square at float32 and 620 at bfloat16, and 4 * n_iter * radius
    must stay below that side: radius 8 takes 13 rounds at float32, not
    14), or more strips than
    its table holds (128 row and column strips together: maps of about
    24,000 by 24,000 float32 pixels at radius 4 and 4 rounds), or more
    than 65535 maps."""
    if not 1 <= radius <= MAX_RADIUS:
        raise ValueError(f"nms_plan: kernel C is compiled for radius 1.."
                         f"{MAX_RADIUS}, not {radius}")
    if n_iter < 1 or not 1 <= B <= MAX_MAPS or H < 1 or W < 1:
        raise ValueError(f"nms_plan: n_iter {n_iter} on a ({B}, {H}, {W}) "
                         f"map")

    def cap(w):
        return _cluster_rows(w, element_size, radius, smem)

    if cap(1) < 1:
        raise ValueError(f"nms_plan: {smem} bytes of shared memory a block "
                         f"hold no row")
    if H <= cap(W):
        ghost, width = 0, W
        row_strips, col_strips = ((0, H, 0, H),), ((0, W, 0, W),)
    else:
        ghost = 2 * n_iter * radius
        lo, hi = 1, W   # the widest w with cap(w) >= min(H, w)
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if cap(mid) >= min(H, mid):
                lo = mid
            else:
                hi = mid - 1
        if lo < W and lo >= 8:
            lo -= lo % 8   # strips on 16-byte boundaries where ghost allows
        col_strips = _cut(W, lo, ghost)
        row_strips = _cut(H, cap(lo), ghost)
        if row_strips is None or col_strips is None:
            raise ValueError(
                f"nms_plan: a cluster holds {cap(lo)} rows of {lo} columns, "
                f"too few for {ghost} ghost rows and columns on each side")
        width = max(l1 - l0 for _, _, l0, l1 in col_strips)
    if len(row_strips) + len(col_strips) > MAX_STRIPS:
        raise ValueError(f"nms_plan: {len(row_strips)} row strips and "
                         f"{len(col_strips)} column strips, the kernel's "
                         f"table holds {MAX_STRIPS}")
    rows = -(-max(l1 - l0 for _, _, l0, l1 in row_strips) // CLUSTER)
    return NmsPlan(CLUSTER, rows, width, ghost, row_strips, col_strips,
                   smem_bytes(rows, width, element_size, radius))


@functools.lru_cache(maxsize=64)
def _strip_table(plan: NmsPlan) -> ctypes.Array:
    """The plan's row strips then column strips as the C int array the
    entry point takes."""
    flat = [v for strip in plan.row_strips + plan.col_strips for v in strip]
    return (ctypes.c_int * len(flat))(*flat)


def nms_rounds(score: torch.Tensor, radius: int,
               n_iter: int = 4) -> torch.Tensor:
    """(B, H, W) score map -> suppressed map after `n_iter` rounds.

    CPU tensor: the plain version. CUDA tensor: the CUDA kernel, one
    launch of clusters for all rounds and tiles (`nms_plan`), or
    an exception; never the plain version."""
    if score.device.type == "cpu":
        return nms_rounds_plain(score, radius, n_iter)
    if score.device.type != "cuda":
        raise ValueError(f"nms_rounds: unsupported device {score.device}")
    if score.ndim != 3:
        raise ValueError(f"nms_rounds: expected (B, H, W), got "
                         f"{tuple(score.shape)}")
    if radius < 1 or n_iter < 1:
        raise ValueError("nms_rounds: radius and n_iter must be >= 1")
    if score.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError("nms_rounds has no backward")
    code = dtype_code(score.dtype)
    B, H, W = score.shape
    plan = nms_plan(B, H, W, radius, n_iter, score.element_size())
    score = score.contiguous()
    lib = library("nms")
    out = torch.empty_like(score)
    with torch.cuda.device(score.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ei_nms_rounds(code, score.data_ptr(), out.data_ptr(), B,
                                H, W, radius, n_iter, plan.rows,
                                len(plan.row_strips), len(plan.col_strips),
                                _strip_table(plan), stream)
    check(err, "nms_rounds")
    nms_rounds.launches += 1
    return out


nms_rounds.launches = 0
