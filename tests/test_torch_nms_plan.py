"""Kernel C's plan (ei_nexus_tpu_torch.ops.nms_kernel.nms_plan), pure Python,
on the CPU: the cluster, the rows a block holds and the tiles of a map (row
strips by column strips), what it refuses, and its tile decomposition
emulated with the plain version: each tile's loaded rows and columns (its
own plus ghost rows and columns) run through `nms_rounds_plain`, its own
part stitched together, must equal the whole map's result bit for bit
(max, compare and select only).
"""

import numpy as np
import pytest
import torch

from ei_nexus_tpu_torch.ops.nms_kernel import (CLUSTER, MAX_STRIPS, NmsPlan,
                                               nms_plan, nms_rounds_plain,
                                               smem_bytes)
from tests.test_torch_threads import one_torch_thread  # noqa: F401

FULL = 232448  # the shared memory a Hopper block may use


def _maps(rng, shape):
    """A sparse random map with exact-zero ties, and a plateau map: scores
    rounded to multiples of 1/8, so neighbouring positive peaks tie."""
    s = rng.uniform(0, 1, shape).astype(np.float32)
    s[s < 0.4] = 0
    plateau = (np.round(rng.uniform(0, 1, shape) * 8) / 8).astype(np.float32)
    plateau[plateau < 0.3] = 0
    return s, plateau


def _check_cut(strips, n: int, ghost: int, capacity: int):
    """Own rows (or columns) partition [0, n); every strip loads exactly
    `ghost` beyond its own on each side, clipped at the edges, and at most
    `capacity`."""
    assert strips[0][0] == 0 and strips[-1][1] == n
    for (o0, o1, l0, l1), nxt in zip(strips, strips[1:] + (None,)):
        assert o0 < o1
        assert l0 == max(0, o0 - ghost)
        assert l1 == min(n, o1 + ghost)
        assert l1 - l0 <= capacity
        if nxt is not None:
            assert nxt[0] == o1


def _check_strips(plan: NmsPlan, H: int, radius: int, n_iter: int,
                  W: int = None):
    """The plan's tiles: exactly 2*n_iter*r ghost rows and columns, a
    tile's loaded rows fit in the cluster's blocks, its loaded columns in
    `width`."""
    assert plan.ghost == 2 * n_iter * radius
    _check_cut(plan.row_strips, H, plan.ghost, plan.cluster * plan.rows)
    if W is not None:
        _check_cut(plan.col_strips, W, plan.ghost, plan.width)
    assert plan.width == max(l1 - l0 for _, _, l0, l1 in plan.col_strips)


def test_plan_flagship():
    """The flagship's padded map (8, 264, 352) is one cluster of 8 blocks,
    33 rows each, no ghost rows; float32 and bfloat16."""
    for es in (4, 2):
        plan = nms_plan(8, 264, 352, 4, 4, es)
        # words: is_max, zero, dilated (+ halo); pixels: the map, the row
        # pass (+ halo)
        smem = 4 * 11 * (3 * 33 + 8) + es * 352 * (33 + 41)
        assert plan == NmsPlan(CLUSTER, 33, 352, 0, ((0, 264, 0, 264),),
                               ((0, 352, 0, 352),), smem)
        assert CLUSTER == 8
        assert plan.smem_bytes == smem_bytes(33, 352, es, 4) <= FULL


@pytest.mark.parametrize("shape,radius,n_iter,rows", [
    ((2, 70, 90), 4, 4, 9),
    ((3, 33, 47), 2, 3, 5),
    ((2, 7, 9), 4, 4, 1),        # fewer rows a block than r: further ranks
    ((2, 180, 240), 4, 4, 23),   # the EC dataset's maps
])
def test_plan_one_cluster(shape, radius, n_iter, rows):
    B, H, W = shape
    plan = nms_plan(B, H, W, radius, n_iter, 4)
    assert (plan.cluster, plan.rows, plan.width, plan.ghost) == (
        CLUSTER, rows, W, 0)
    assert plan.row_strips == ((0, H, 0, H),)
    assert plan.col_strips == ((0, W, 0, W),)


@pytest.mark.parametrize("H,W,radius,n_iter,es,per_block", [
    (120, 40, 3, 2, 4, 5),
    (64, 33, 1, 3, 4, 2),
    (300, 90, 4, 4, 2, 20),
    (97, 47, 2, 3, 2, 4),
])
def test_plan_strips_on_a_small_budget(H, W, radius, n_iter, es, per_block):
    """A budget of `per_block` rows of W a block forces several tiles."""
    smem = smem_bytes(per_block, W, es, radius)
    plan = nms_plan(1, H, W, radius, n_iter, es, smem=smem)
    assert len(plan.row_strips) > 1
    assert plan.smem_bytes <= smem
    assert plan.smem_bytes == smem_bytes(plan.rows, plan.width, es, radius)
    _check_strips(plan, H, radius, n_iter, W)


def test_plan_strips_at_full_budget():
    """(1, 1024, 1280) float32, as the card test runs it: a cluster holds
    136 rows of 1280, too few, so the map is cut into tiles of 448
    columns, whose cluster holds 464 rows: 3 row strips by 4 column
    strips, 32 ghost rows and columns each side."""
    plan = nms_plan(1, 1024, 1280, 4, 4, 4)
    assert (plan.rows, plan.width) == (58, 448)
    assert (len(plan.row_strips), len(plan.col_strips)) == (3, 4)
    _check_strips(plan, 1024, 4, 4, 1280)
    assert plan.row_strips[0] == (0, 432, 0, 464)
    assert plan.col_strips[0] == (0, 416, 0, 448)
    assert plan.smem_bytes <= FULL


@pytest.mark.parametrize("shape,es", [
    ((1, 512, 3840), 4),     # a 4K-wide float32 map
    ((1, 512, 3840), 2),
    ((1, 1080, 3840), 4),
    ((1, 16, 20000), 4),     # short and wide: one row strip
    ((1, 4096, 200), 4),     # tall and narrow: row strips only
])
def test_plan_wide_maps(shape, es):
    """Maps whose rows do not fit a cluster's blocks, or whose tiles are
    better square, are cut into columns too; 16-byte column boundaries
    where the width allows; everything within a block's shared memory."""
    B, H, W = shape
    plan = nms_plan(B, H, W, 4, 4, es)
    _check_strips(plan, H, 4, 4, W)
    assert plan.smem_bytes == smem_bytes(plan.rows, plan.width, es, 4)
    assert plan.smem_bytes <= FULL
    if W == 200:
        assert plan.col_strips == ((0, W, 0, W),)
    else:
        assert len(plan.col_strips) > 1
    if H == 16:
        assert plan.row_strips == ((0, H, 0, H),)
    for strip in plan.col_strips:
        assert all(v % 8 == 0 or v == W for v in strip)


@pytest.mark.parametrize("kw", [
    dict(radius=0), dict(radius=9),            # radii not compiled
    dict(H=100000, W=100000),                  # over the table
    dict(smem=smem_bytes(1, 64, 4, 4)),        # tiles own nothing
    dict(B=0),
    dict(H=600, W=600, radius=8, n_iter=14),   # 4 * 8 * 14 ghost > 440
    dict(H=40000, smem=smem_bytes(12, 352, 4, 4)),  # over the table
    dict(n_iter=0),
    dict(B=65536),                             # over the grid's maps
])
def test_plan_refuses(kw):
    args = dict(B=8, H=264, W=352, radius=4, n_iter=4, element_size=4)
    args.update(kw)
    with pytest.raises(ValueError):
        nms_plan(**args)


def test_plan_ghost_boundary():
    """At float32 and the full budget a cut map's tiles are 440 square, so
    radius 8 plans up to 13 rounds (4 * 8 * 13 = 416 ghost rows and
    columns a tile) and refuses 14 (448); bfloat16's larger tiles take
    14."""
    plan = nms_plan(1, 600, 600, 8, 13, 4)
    assert plan.width == 440 and plan.ghost == 208
    _check_strips(plan, 600, 8, 13, 600)
    with pytest.raises(ValueError, match="too few for 224 ghost"):
        nms_plan(1, 600, 600, 8, 14, 4)
    _check_strips(nms_plan(1, 1000, 1000, 8, 14, 2), 1000, 8, 14, 1000)


def test_plan_strip_table_bound():
    """The largest table the kernel holds is accepted, one more strip is
    refused."""
    W, es = 64, 4
    smem = smem_bytes(9, W, es, 4)  # 72 rows a cluster: the first owns 40,
    H = 80 + 8 * (MAX_STRIPS - 3)     # each further one 8, the last 40
    plan = nms_plan(1, H, W, 4, 4, es, smem=smem)
    assert plan.col_strips == ((0, W, 0, W),)
    assert len(plan.row_strips) + len(plan.col_strips) == MAX_STRIPS
    _check_strips(plan, H, 4, 4, W)
    with pytest.raises(ValueError):
        nms_plan(1, H + 8, W, 4, 4, es, smem=smem)


def _stitched(s: np.ndarray, plan: NmsPlan, radius: int, n_iter: int):
    """What the kernel computes under `plan`, with the plain version: each
    tile runs all rounds on its loaded rows and columns alone (the map-edge
    fill at their edges) and keeps its own part."""
    out = np.full_like(s, np.nan)
    for o0, o1, l0, l1 in plan.row_strips:
        for c0, c1, k0, k1 in plan.col_strips:
            part = nms_rounds_plain(torch.from_numpy(s[:, l0:l1, k0:k1]),
                                    radius, n_iter).numpy()
            out[:, o0:o1, c0:c1] = part[:, o0 - l0:o1 - l0, c0 - k0:c1 - k0]
    return out


@pytest.mark.parametrize("shape,radius,n_iter,per_block", [
    ((2, 120, 40), 3, 2, 5),
    ((1, 64, 33), 1, 3, 2),
    ((2, 150, 90), 4, 4, 16),
    ((1, 97, 47), 2, 3, 4),
    ((1, 200, 64), 4, 1, 3),
])
def test_strip_decomposition_exact(rng, shape, radius, n_iter, per_block):
    B, H, W = shape
    plan = nms_plan(B, H, W, radius, n_iter, 4,
                    smem=smem_bytes(per_block, W, 4, radius))
    assert len(plan.row_strips) > 1
    for s in _maps(rng, shape):
        want = nms_rounds_plain(torch.from_numpy(s), radius, n_iter).numpy()
        np.testing.assert_array_equal(_stitched(s, plan, radius, n_iter),
                                      want)


@pytest.mark.parametrize("shape,radius,n_iter,smem", [
    ((1, 40, 300), 3, 2, smem_bytes(2, 300, 4, 3)),   # columns alone cut
    ((2, 90, 170), 2, 3, smem_bytes(3, 170, 4, 2)),   # rows and columns
    ((1, 120, 128), 4, 4, smem_bytes(9, 128, 4, 4)),
    ((1, 512, 3840), 4, 4, FULL),                     # a 4K-wide map
])
def test_tile_decomposition_exact(rng, shape, radius, n_iter, smem):
    """Maps cut into column strips too: stitched tiles equal the whole
    map's result bit for bit, on random and plateau maps."""
    B, H, W = shape
    plan = nms_plan(B, H, W, radius, n_iter, 4, smem=smem)
    assert len(plan.col_strips) > 1
    _check_strips(plan, H, radius, n_iter, W)
    for s in _maps(rng, shape):
        want = nms_rounds_plain(torch.from_numpy(s), radius, n_iter).numpy()
        np.testing.assert_array_equal(_stitched(s, plan, radius, n_iter),
                                      want)
