"""The traffic generator: seeded event streams, frames and stage-2
supervision, from a mix's parameters.

The stream generator is a copy of `ei_nexus_tpu_torch/data/synth.py`
(numpy only, the same numbers for the same generator state): temporally
bursty, spatially clustered events with hot pixels and exact timestamp
ties. Every batch of a pool has the same shapes and the same number of
events, so every seed gives the program the same amount of work.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

EVENT_KEYS = ("events_x", "events_y", "events_t", "events_p", "events_valid")


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


def event_batch(rng: np.random.Generator, mix: dict, batch: int,
                height: int, width: int) -> Dict[str, np.ndarray]:
    """(batch, slots) padded event arrays: each row `fill` of `event_slots`
    slots full, tail-padded, with its validity mask."""
    slots = mix["event_slots"]
    n = int(round(mix["fill"] * slots))
    out = {k: np.zeros((batch, slots), np.float32) for k in EVENT_KEYS[:4]}
    out["events_valid"] = np.zeros((batch, slots), bool)
    for b in range(batch):
        x, y, t, p = bursty_events(
            rng, n, height, width, mix.get("bursts", 12),
            mix.get("hot_frac", 0.3), mix.get("tie_frac", 0.1),
            mix.get("t_max", 0.4))
        for k, v in zip(EVENT_KEYS, (x, y, t, p)):
            out[k][b, :n] = v
        out["events_valid"][b, :n] = True
    return out


def frames(rng: np.random.Generator, batch: int, height: int, width: int
           ) -> np.ndarray:
    """(batch, H, W, 1) grayscale frames, uniform in [0, 255]."""
    return rng.uniform(0, 255, (batch, height, width, 1)).astype(np.float32)


def serve_pool(seed: int, mix: dict, height: int, width: int
               ) -> List[Dict[str, np.ndarray]]:
    """`pool` distinct batches of event-frame pairs drawn from `seed`."""
    rng = np.random.default_rng(seed)
    pool = []
    for _ in range(mix["pool"]):
        b = event_batch(rng, mix, mix["batch"], height, width)
        b["image"] = frames(rng, mix["batch"], height, width)
        pool.append(b)
    return pool


def stage2_pool(seed: int, mix: dict, height: int, width: int
                ) -> List[Dict[str, np.ndarray]]:
    """`pool` distinct stage-2 batches drawn from `seed`, as
    `tools/bench_train.py` builds them: view 0's bursty events, view 1's
    frame, K = [[f, 0, W/2], [0, f, H/2], [0, 0, 1]] for both, a constant
    depth map for both, T01 an x-translation by `shift`, T10 its
    inverse."""
    rng = np.random.default_rng(seed)
    B = mix["batch"]
    f = mix["focal"]
    K = np.tile(np.array([[f, 0, width / 2], [0, f, height / 2], [0, 0, 1]],
                         np.float32), (B, 1, 1))
    depth = np.full((B, height, width), mix["depth"], np.float32)
    T01 = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    T01[:, 0, 3] = mix["shift"]
    T10 = np.linalg.inv(T01).astype(np.float32)
    pool = []
    for _ in range(mix["pool"]):
        b = event_batch(rng, mix, B, height, width)
        b.update(image=frames(rng, B, height, width), K=K, depth0=depth,
                 depth1=depth, T01=T01, T10=T10)
        pool.append(b)
    return pool


def pinned(pool, device) -> list:
    """Each batch as torch tensors, in pinned host memory when the device
    is a GPU (so copies to it may run behind the host)."""
    import torch
    pin = torch.device(device).type == "cuda"
    return [{k: (torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                 if pin else torch.from_numpy(np.ascontiguousarray(v)))
             for k, v in b.items()} for b in pool]


def to_device(batch, device) -> dict:
    return {k: v.to(device, non_blocking=True) for k, v in batch.items()}
