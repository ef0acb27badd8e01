"""The port's event representations (ei_nexus_tpu_torch.data,
train.steps.batch_representation) against the JAX package's exact-scatter
path, on bursty event streams, on the CPU: the voxel grid, and the time
surface, event stack, distance map and accumulation image bit for bit
(maxima, integer sums, min-plus with one float32 add a candidate).

The port scatters with index_add_ in the JAX package's order (the 8 corner
passes, events in order), so the raw voxel sums match bit for bit on the
CPU; the standardisation's mean and std are float32 sums in another order
(relative error ~1e-6, and hot pixels reach |v| ~ 10), hence atol 1e-5
with rtol 1e-5 on the normalised grid.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ei_nexus_tpu.data import representations as jreps
from ei_nexus_tpu.data.synth import bursty_event_batch as jax_bursty_batch
from ei_nexus_tpu.train.steps import batch_representation as jax_batch_rep
from ei_nexus_tpu_torch.data import representations as treps
from ei_nexus_tpu_torch.data.synth import bursty_event_batch
from ei_nexus_tpu_torch.train.steps import batch_representation


def _t(a):
    return torch.from_numpy(np.array(a))


def test_bursty_event_batch_is_the_same_generator():
    a = jax_bursty_batch(np.random.default_rng(3), 2, 1000, 1200, 32, 48)
    b = bursty_event_batch(np.random.default_rng(3), 2, 1000, 1200, 32, 48)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("n,max_events,bins,hw", [
    (3000, 4096, 4, (32, 48)),
    (5000, 4096, 16, (30, 45)),      # truncated window, odd sizes
    (0, 512, 5, (16, 24)),           # no events at all
])
def test_batch_representation_matches_jax(n, max_events, bins, hw):
    H, W = hw
    ev = bursty_event_batch(np.random.default_rng(1), 2, n, max_events, H, W)
    want_rep, want_mask = jax_batch_rep(ev, "VoxelGrid", bins, H, W,
                                        fast=False)
    rep, mask = batch_representation(ev, "VoxelGrid", bins, H, W,
                                     device="cpu")
    assert rep.shape == (2, H, W, bins) and mask.shape == (2, H, W)
    np.testing.assert_allclose(rep.numpy(), np.asarray(want_rep), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))


def test_voxel_grid_raw_sums_bit_exact():
    H, W, bins = 32, 48, 6
    ev = bursty_event_batch(np.random.default_rng(2), 2, 2000, 2048, H, W)
    for b in range(2):
        want = jreps.events_to_voxel_grid(
            jnp.asarray(ev["events_x"][b]), jnp.asarray(ev["events_y"][b]),
            jnp.asarray(ev["events_t"][b]), jnp.asarray(ev["events_p"][b]),
            bins=bins, height=H, width=W,
            mask=jnp.asarray(ev["events_valid"][b]), normalize=False)
        got = treps.events_to_voxel_grid(
            *(_t(ev[k][b:b + 1]) for k in ("events_x", "events_y",
                                           "events_t", "events_p")),
            bins=bins, height=H, width=W,
            mask=_t(ev["events_valid"][b:b + 1]), normalize=False)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))


def test_normalize_time_and_accumulation(rng):
    t = np.sort(rng.uniform(0, 0.4, (2, 50)), axis=1).astype(np.float32)
    mask = np.arange(50)[None] < np.array([[40], [0]])
    for m in (None, mask):
        want = np.stack([np.asarray(jreps.normalize_time(
            jnp.asarray(t[b]), None if m is None else jnp.asarray(m[b])))
            for b in range(2)])
        got = treps.normalize_time(_t(t), None if m is None else _t(m))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    x = rng.uniform(-2, 50, (2, 300)).astype(np.float32)
    y = rng.uniform(-2, 34, (2, 300)).astype(np.float32)
    valid = rng.uniform(size=(2, 300)) > 0.1
    want = np.stack([np.asarray(jreps.events_to_accumulation_image(
        jnp.asarray(x[b]), jnp.asarray(y[b]), height=32, width=48,
        mask=jnp.asarray(valid[b]))) for b in range(2)])
    got = treps.events_to_accumulation_image(_t(x), _t(y), height=32,
                                             width=48, mask=_t(valid))
    np.testing.assert_array_equal(got.numpy(), want)


def test_pad_events_matches_jax(rng):
    x, y, t, p = (rng.uniform(size=10).astype(np.float32) for _ in range(4))
    for length in (4, 10, 16):
        for a, b in zip(jreps.pad_events(x, y, t, p, length),
                        treps.pad_events(x, y, t, p, length)):
            np.testing.assert_array_equal(a, b)


OTHER_KINDS = ("TimeSurface", "EventStack", "DistanceMap",
               "AccumulationImage")


def _edge_events(seed, B, n, max_events, H, W, bins, polarities=(0, 1)):
    """Bursty events whose normalised stamps are their own stamps (each
    row's valid window runs from exactly 0 to exactly 1, and 1 + 1e-8 is 1
    in float32), a fifth of them moved onto bin edges b / bins and
    b / (bins // 2) (the time surface's), some out of the frame on every
    side, and some interior slots masked."""
    rng = np.random.default_rng(seed)
    ev = bursty_event_batch(rng, B, n, max_events, H, W)
    t, valid = ev["events_t"], ev["events_valid"]
    edges = np.unique(np.float32(np.concatenate([
        np.arange(bins + 1) / bins,
        np.arange(bins // 2 + 1) / max(bins // 2, 1)])))
    for b in range(B):
        idx = np.flatnonzero(valid[b])
        if len(idx) < 2:
            continue
        tv = t[b, idx].astype(np.float64)
        tv = (tv - tv.min()) / max(tv.max() - tv.min(), 1e-12)
        ends = [np.argmin(tv), np.argmax(tv)]
        tv[ends] = [0.0, 1.0]
        on_edge = rng.uniform(size=len(idx)) < 0.2
        on_edge[ends] = False
        tv[on_edge] = rng.choice(edges, on_edge.sum())
        t[b, idx] = tv.astype(np.float32)
        # the window's ends stay valid, so the stamps stay normalised
        out = rng.choice(np.delete(idx, ends), 8, replace=False)
        ev["events_x"][b, out[:2]] = [-1.5, W + 0.25]
        ev["events_y"][b, out[2:4]] = [-3.0, H]
        ev["events_x"][b, out[4]] = W - 0.5       # inside, at the edge
        valid[b, out[5:]] = False
    ev["events_p"] = rng.choice(np.asarray(polarities, np.float32),
                                ev["events_p"].shape)
    return ev


def _jax_per_sample(kind, ev, bins, H, W):
    return np.stack([np.asarray(jreps.build_representation(
        kind, *(jnp.asarray(ev[k][b]) for k in ("events_x", "events_y",
                                                "events_t", "events_p")),
        bins=bins, height=H, width=W, mask=jnp.asarray(ev["events_valid"][b])))
        for b in range(ev["events_x"].shape[0])])


@pytest.mark.parametrize("kind", OTHER_KINDS)
@pytest.mark.parametrize("bins,hw,polarities", [
    (4, (24, 32), (0, 1)), (6, (17, 23), (0, 1)),
    (5, (16, 20), (-1, 0, 1, 2))],
    ids=["4bins", "6bins-odd-frame", "5bins-wild-polarity"])
def test_representation_matches_jax_bit_for_bit(kind, bins, hw,
                                                polarities):
    """Each representation on bursty events with stamps exactly on bin
    edges (they land in both bins), events out of the frame and masked
    slots, against the JAX function per sample: bit-equal. Polarities
    beyond {0, 1} take the JAX scatter's index rule (a negative index
    wraps once, one beyond the map is dropped)."""
    H, W = hw
    ev = _edge_events(3, 3, 700, 1024, H, W, bins, polarities)
    want = _jax_per_sample(kind, ev, bins, H, W)
    got = treps.build_representation(
        kind, *(_t(ev[k]) for k in ("events_x", "events_y", "events_t",
                                    "events_p")),
        bins=bins, height=H, width=W, mask=_t(ev["events_valid"]))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got != 0).any()
    # interior bin edges are hit by valid events
    tn = treps.normalize_time(_t(ev["events_t"]), _t(ev["events_valid"]))
    on = tn[_t(ev["events_valid"])]
    assert ((on == 0.5) | (on == float(np.float32(1 / bins)))).sum() > 10


def test_voxel_grid_through_build_representation():
    H, W, bins = 24, 32, 5
    ev = _edge_events(4, 2, 900, 1024, H, W, bins)
    want = _jax_per_sample("VoxelGrid", ev, bins, H, W)
    got = treps.build_representation(
        "VoxelGrid", *(_t(ev[k]) for k in ("events_x", "events_y",
                                           "events_t", "events_p")),
        bins=bins, height=H, width=W, mask=_t(ev["events_valid"]))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_distance_map_with_few_iterations():
    """n_iter bounds the propagation: far pixels keep 1e9 and read 0."""
    H, W, bins = 20, 30, 2
    ev = _edge_events(5, 2, 40, 64, H, W, bins)
    for n_iter in (1, 3):
        want = np.stack([np.asarray(jreps.events_to_distance_map(
            *(jnp.asarray(ev[k][b]) for k in ("events_x", "events_y",
                                              "events_t", "events_p")),
            bins=bins, height=H, width=W,
            mask=jnp.asarray(ev["events_valid"][b]), n_iter=n_iter))
            for b in range(2)])
        got = treps.events_to_distance_map(
            *(_t(ev[k]) for k in ("events_x", "events_y", "events_t",
                                  "events_p")),
            bins=bins, height=H, width=W, mask=_t(ev["events_valid"]),
            n_iter=n_iter)
        np.testing.assert_array_equal(got.numpy(), want)
        assert float(got.max()) <= n_iter * 1.3693 + 1e-6


def test_other_representations_not_ported():
    """`batch_representation` takes every kind of `build_representation`
    as the JAX function's exact path (fast=False) does: bit-equal for the
    four kinds other than the voxel grid (tested above), the mask equal;
    an unknown kind raises ValueError naming the choices, on both."""
    H, W, bins = 26, 34, 4
    ev = _edge_events(6, 2, 1500, 2048, H, W, bins)
    for kind in OTHER_KINDS:
        want_rep, want_mask = jax_batch_rep(ev, kind, bins, H, W,
                                            fast=False)
        rep, mask = batch_representation(ev, kind, bins, H, W, device="cpu")
        channels = 1 if kind == "AccumulationImage" else bins
        assert rep.shape == (2, H, W, channels), kind
        np.testing.assert_array_equal(rep.numpy(), np.asarray(want_rep),
                                      err_msg=kind)
        np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
    with pytest.raises(ValueError, match="AccumulationImage"):
        batch_representation(ev, "Histogram", bins, H, W, device="cpu")
    with pytest.raises(ValueError, match="AccumulationImage"):
        jax_batch_rep(ev, "Histogram", bins, H, W, fast=False)
