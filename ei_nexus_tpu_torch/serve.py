"""The loader-fed serving loop: batches from a `DataLoader` through the
wire encode and the transfer to the card, then the model's forward.

Counterpart of the JAX package's end-to-end bench pass (`bench.py:
run_bench_e2e`, `one_pass`). `serve_loader` enqueues each batch's forward
without waiting for it and reads every batch's scalar only at the end, so
loading, encoding, the transfer and the device's work overlap as they
would in a server; the clock stops when the last scalar arrives.
`serve_host_only` runs the same loader and encode with no device work,
which gives the host's share of the served wall time.

A caller with MVSEC on disk passes a `DataLoader` over
`data.mvsec.fetch_mvsec_dataset(cfg, "train")`; any map-style dataset with
the readers' sample contract (a (data0, data1, T01, T10) tuple whose
data0 holds the padded events and the "image") serves alike.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple, Union

import torch

from .data.pipeline import DataLoader, PinnedPut, device_prefetch
from .device import resolve_device
from .train.steps import batch_representation, compact_event_view


def serve_loader(model: torch.nn.Module, loader: DataLoader, bins: int,
                 H: int, W: int,
                 device: Optional[Union[str, torch.device]] = None,
                 max_batches: int = 0) -> Tuple[float, int]:
    """One pass over `loader` (epoch 0, at most `max_batches` batches when
    > 0): each batch's data0 goes through `compact_event_view(keep=
    ("image",))` and `device_prefetch` with a `PinnedPut`
    to `device` (the card unless the caller names another), then the
    voxel grid and `model`'s forward; the batch's scalar (the sum of
    matching_scores0) stays on the device until the pass ends. Returns
    (wall seconds, pairs served)."""
    dev = resolve_device(device)
    put = PinnedPut(dev)
    loader.set_epoch(0)
    outs = []
    t0 = time.perf_counter()
    batches = device_prefetch(
        iter(loader),
        lambda b: put(compact_event_view(b[0], keep=("image",))))
    with torch.inference_mode():
        for enc in batches:
            rep, mask = batch_representation(enc, "VoxelGrid", bins, H, W,
                                             device=dev)
            _, _, m = model(rep, enc["image"], mask)
            outs.append(m["matching_scores0"].sum())
            if max_batches and len(outs) >= max_batches:
                break
        done = [float(o) for o in outs]    # every batch has completed
    wall = time.perf_counter() - t0
    return wall, len(done) * loader.local_batch


def serve_host_only(loader: DataLoader, max_batches: int = 0
                    ) -> Tuple[float, int]:
    """The host's part of `serve_loader` alone: the loader and the wire
    encode, no transfer and no device work. Returns (wall seconds, pairs
    served)."""
    loader.set_epoch(0)
    counts = []
    t0 = time.perf_counter()
    for b in loader:
        enc = compact_event_view(b[0], keep=("image",))
        counts.append(int(enc["events_n"].sum()))
        if max_batches and len(counts) >= max_batches:
            break
    wall = time.perf_counter() - t0
    return wall, len(counts) * loader.local_batch
