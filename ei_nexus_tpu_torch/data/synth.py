"""Synthetic event-stream generators with realistic statistics.

A copy of `ei_nexus_tpu/data/synth.py` (numpy only): temporally bursty,
spatially clustered streams with hot pixels and exact timestamp ties, the
regime that stresses voxelization and NMS. Same generator, same numbers.
`stage2_batch` wraps them into the stage-2 training batch,
`homography_batch` into the homography-supervised step's.
"""

from __future__ import annotations

import numpy as np

from .representations import pad_events


def bursty_events(rng: np.random.Generator, n: int, height: int, width: int,
                  n_bursts: int = 12, hot_frac: float = 0.3,
                  tie_frac: float = 0.1, t_max: float = 0.4):
    """Sorted (x, y, t, p) float32 arrays with bursts, hot pixels, ties."""
    centers = np.sort(rng.uniform(0.05 * t_max, 0.95 * t_max, n_bursts))
    which = rng.integers(0, n_bursts, n)
    t = centers[which] + rng.normal(0, 0.01 * t_max, n)
    t = np.clip(t, 0, t_max)
    n_tie = int(n * tie_frac)
    if n_tie:
        t[:n_tie] = t[rng.integers(0, n, n_tie)]
    t = np.sort(t).astype(np.float32)

    hot = rng.integers(0, [height - 1, width - 1], (8, 2))
    is_hot = rng.uniform(size=n) < hot_frac
    hi = rng.integers(0, len(hot), n)
    x = np.where(is_hot, hot[hi, 1] + rng.uniform(0, 1, n),
                 rng.uniform(0, width - 1, n)).astype(np.float32)
    y = np.where(is_hot, hot[hi, 0] + rng.uniform(0, 1, n),
                 rng.uniform(0, height - 1, n)).astype(np.float32)
    p = rng.integers(0, 2, n).astype(np.float32)
    return x, y, t, p


def bursty_event_batch(rng: np.random.Generator, batch: int, n: int,
                       max_events: int, height: int, width: int,
                       **kwargs):
    """Batched padded views ready for `batch_representation`."""
    out = {k: [] for k in ("events_x", "events_y", "events_t", "events_p",
                           "events_valid")}
    for _ in range(batch):
        x, y, t, p = bursty_events(rng, n, height, width, **kwargs)
        xp, yp, tp, pp, m = pad_events(x, y, t, p, max_events)
        for k, v in zip(out, (xp, yp, tp, pp, m)):
            out[k].append(v)
    return {k: np.stack(v) for k, v in out.items()}


def stage2_batch(rng: np.random.Generator, batch: int, n: int,
                 max_events: int, height: int, width: int,
                 focal: float = 199.0, depth: float = 2.0,
                 shift: float = 0.05):
    """A stage-2 training batch (data0, data1, T01, T10), as
    tools/bench_train.py builds it: view 0 carries bursty events (`n` of
    `max_events` slots), view 1 a random frame in [0, 255]; both views have
    K = [[f, 0, W/2], [0, f, H/2], [0, 0, 1]] and a constant depth map;
    T01 is an x-translation by `shift` and T10 its inverse. View 1's events
    are never read by the step, so it has none."""
    data0 = bursty_event_batch(rng, batch, n, max_events, height, width)
    K = np.tile(np.array([[focal, 0, width / 2], [0, focal, height / 2],
                          [0, 0, 1]], np.float32), (batch, 1, 1))
    dmap = np.full((batch, height, width), depth, np.float32)
    data0.update(K=K, depth=dmap)
    data1 = {"image": rng.uniform(0, 255, (batch, height, width, 1)
                                  ).astype(np.float32),
             "K": K.copy(), "depth": dmap.copy()}
    T01 = np.tile(np.eye(4, dtype=np.float32), (batch, 1, 1))
    T01[:, 0, 3] = shift
    return data0, data1, T01, np.linalg.inv(T01).astype(np.float32)


def homography_batch(rng: np.random.Generator, batch: int, n: int,
                     max_events: int, height: int, width: int):
    """The homography-supervised stage-2 step's batch (data0,): bursty
    events (`n` of `max_events` slots) and a random frame in [0, 255],
    both on the (height, width) grid."""
    data0 = bursty_event_batch(rng, batch, n, max_events, height, width)
    data0["image"] = rng.uniform(0, 255, (batch, height, width, 1)).astype(
        np.float32)
    return (data0,)
