"""Host-side data loading: epoch-seeded sharded sampling + threaded
prefetch. A copy of `link_tpu/data/loader.py`, kept here so the port
imports nothing of the JAX package.

Replaces torch DataLoader + DistributedSampler (reference:
segmentation/train.py:82-93, detection/det3d/datasets/loader/sampler.py:16
-64). Workers are threads (the pipeline is NumPy-heavy but releases the
GIL in big ops); the sampler shards deterministically per epoch like
DistributedSampler(set_epoch).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, List, Optional

import numpy as np


def epoch_indices(n: int, epoch: int, seed: int = 0,
                  shuffle: bool = True) -> np.ndarray:
    rng = np.random.default_rng(seed + epoch)
    idx = np.arange(n)
    if shuffle:
        rng.shuffle(idx)
    return idx


def shard_indices(indices: np.ndarray, num_shards: int,
                  drop_last: bool = True) -> List[np.ndarray]:
    """Contiguous round-robin shards, padded like DistributedSampler when
    not dropping."""
    if drop_last:
        n = len(indices) // num_shards * num_shards
        indices = indices[:n]
    else:
        pad = (-len(indices)) % num_shards
        indices = np.concatenate([indices, indices[:pad]])
    return [indices[i::num_shards] for i in range(num_shards)]


class PrefetchLoader:
    """Iterate batches produced by `make_batch(step)` with a background
    thread keeping `depth` batches ready."""

    def __init__(self, make_batch: Callable[[int], object], num_steps: int,
                 depth: int = 2):
        self.make_batch = make_batch
        self.num_steps = num_steps
        self.depth = depth

    def __iter__(self) -> Iterator:
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        stop = threading.Event()

        def worker():
            for step in range(self.num_steps):
                if stop.is_set():
                    return
                q.put(self.make_batch(step))
            q.put(None)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                yield item
        finally:
            stop.set()

    def __len__(self):
        return self.num_steps
