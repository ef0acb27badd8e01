"""Streaming, host-sharded input pipeline.

Counterpart of `ei_nexus_tpu/data/pipeline.py`, with the same behaviour:
each process owns the `process_index`-th shard of the global index stream,
a thread pool loads samples (HDF5 slicing and PNG decoding release the
GIL), and collated fixed-shape numpy batches are queued ahead on a
background thread. Batches carry padded raw event arrays; the voxel grid is
built on the device (`train/steps.py:batch_representation`).

`device_prefetch` applies a `put` (encode and transfer) inline, or on a
background thread with EI_NEXUS_DEVICE_PREFETCH=1; `PinnedPut` is the put
for the card: pinned host copies, non-blocking transfers.
"""

from __future__ import annotations

import collections
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Iterator, Sequence, Union

import numpy as np
import torch


def collate(samples: Sequence[Any]) -> Any:
    """Stack a list of (possibly nested) numpy sample structures."""
    first = samples[0]
    if isinstance(first, dict):
        return {k: collate([s[k] for s in samples]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(collate([s[i] for s in samples])
                           for i in range(len(first)))
    return np.stack([np.asarray(s) for s in samples])


class DataLoader:
    """Sharded, prefetching batch iterator over a map-style dataset.

    Args:
      dataset: object with __len__/__getitem__ returning numpy structures.
      batch_size: GLOBAL batch size; each process yields
        batch_size // process_count samples.
      shuffle/drop_last/seed: epoch shuffling (seed + epoch defines the
        permutation on every host identically).
      process_index/process_count: this host's shard of the sample stream.
      num_workers: loader threads (0: fetch in the producer thread);
        prefetch: batches queued ahead.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = True, seed: int = 0,
                 process_index: int = 0, process_count: int = 1,
                 num_workers: int = 4, prefetch: int = 2):
        assert batch_size % process_count == 0, \
            "global batch size must divide evenly across hosts"
        self.dataset = dataset
        self.global_batch = batch_size
        self.local_batch = batch_size // process_count
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.process_index = process_index
        self.process_count = process_count
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.epoch = 0
        self.skip_batches = 0

    def set_epoch(self, epoch: int, skip_batches: int = 0):
        """Position the loader at `epoch`, optionally starting mid-epoch.

        skip_batches: number of leading LOCAL batches of this epoch to skip
        (exact mid-epoch resume: the permutation is a pure function of
        seed + epoch). Reset to 0 by the next set_epoch call.
        """
        self.epoch = epoch
        self.skip_batches = skip_batches
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def _epoch_indices(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            order = rng.permutation(n)
        else:
            order = np.arange(n)
        if self.drop_last:
            n_batches = n // self.global_batch
            order = order[: n_batches * self.global_batch]
        # host shard: strided by process index within each global batch
        return order[self.process_index::self.process_count]

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.global_batch
        return -(-n // self.global_batch)

    def __iter__(self) -> Iterator[Any]:
        indices = self._epoch_indices()
        n_local = len(indices) // self.local_batch
        if not self.drop_last and len(indices) % self.local_batch:
            n_local += 1
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        skip = self.skip_batches

        def produce_batches(fetch_many):
            for b in range(skip, n_local):
                if stop.is_set():
                    return
                batch_idx = indices[b * self.local_batch:
                                    (b + 1) * self.local_batch]
                samples = list(fetch_many(batch_idx))
                out_q.put(collate(samples))

        def producer():
            try:
                if self.num_workers > 0:
                    with ThreadPoolExecutor(self.num_workers) as pool:
                        produce_batches(
                            lambda idx: pool.map(self.dataset.__getitem__,
                                                 idx))
                else:  # num_workers=0: fetch synchronously in this thread
                    produce_batches(
                        lambda idx: map(self.dataset.__getitem__, idx))
                out_q.put(None)
            except BaseException as e:  # surface worker errors to consumer
                out_q.put(e)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()


def device_prefetch(iterable, put, depth: int = 2):
    """Apply `put` (encode + transfer) to batches, inline by default, or on
    a background thread `depth` batches ahead of the consumer when
    EI_NEXUS_DEVICE_PREFETCH=1 (the JAX package's switch and default)."""
    if os.environ.get("EI_NEXUS_DEVICE_PREFETCH", "0") == "0":
        for item in iterable:
            yield put(item)
        return
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def worker():
        try:
            for item in iterable:
                if stop.is_set():
                    return
                q.put(put(item))
            q.put(None)
        except BaseException as e:
            q.put(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()


class PinnedPut:
    """A `device_prefetch` put for the card: each numpy array of a (nested)
    batch is copied into a pinned host tensor and sent with
    `.to(device, non_blocking=True)` on the calling thread's current
    stream, which is the stream the consumer's work is enqueued on after
    it (both default to the device's default stream), so the consumer
    reads the batch after its copy.

    A non-blocking copy reads its pinned source when the stream reaches
    it, after `put` has returned: each batch's pinned buffers are held,
    with an event recorded behind its copies, until that event has
    completed (`in_flight` counts the batches still held). On a CPU device
    the arrays become tensors that share their memory; nothing is pinned.
    """

    def __init__(self, device: Union[str, torch.device]):
        self.device = torch.device(device)
        self._held: "collections.deque" = collections.deque()
        self._lock = threading.Lock()

    @property
    def in_flight(self) -> int:
        with self._lock:
            self._release()
            return len(self._held)

    def _release(self) -> None:
        while self._held and self._held[0][0].query():
            self._held.popleft()

    def _send(self, x, pinned: list):
        if isinstance(x, dict):
            return {k: self._send(v, pinned) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return type(x)(self._send(v, pinned) for v in x)
        a = np.asarray(x)
        if not a.flags.c_contiguous:
            a = a.copy()
        t = torch.from_numpy(a)
        if self.device.type != "cuda":
            return t.to(self.device)
        buf = torch.empty(a.shape, dtype=t.dtype, pin_memory=True)
        buf.copy_(t)
        pinned.append(buf)
        return buf.to(self.device, non_blocking=True)

    def __call__(self, batch):
        pinned: list = []
        out = self._send(batch, pinned)
        if pinned:
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
            with self._lock:
                self._release()
                self._held.append((done, pinned))
        return out

    def synchronize(self) -> None:
        """Wait for every held copy and drop its buffers."""
        with self._lock:
            for done, _ in self._held:
                done.synchronize()
            self._held.clear()
