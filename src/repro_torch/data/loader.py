"""Deterministic, resumable batcher (numpy copy of ``repro.data.loader``).

Resumability at *batch* granularity is load-bearing for FedFly: after a
migration the destination edge server must continue from the exact batch
index inside the interrupted epoch, so the loader's state is
(epoch, batch_idx) and its shuffle is a pure function of (seed, epoch).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Tuple

import numpy as np

from repro_torch.data.datasets import ImageDataset


@dataclass
class LoaderState:
    epoch: int = 0
    batch_idx: int = 0


class Batcher:
    def __init__(self, ds: ImageDataset, batch_size: int, seed: int = 0,
                 drop_last: bool = True):
        self.ds = ds
        self.batch_size = batch_size
        self.seed = seed
        n = len(ds)
        self.num_batches = max(n // batch_size if drop_last
                               else -(-n // batch_size), 1)

    def _order(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, epoch))
        return rng.permutation(len(self.ds))

    def batch_at(self, epoch: int, batch_idx: int) -> Dict[str, np.ndarray]:
        order = self._order(epoch)
        lo = batch_idx * self.batch_size
        idx = order[lo:lo + self.batch_size]
        sub = self.ds.subset(idx)
        return {"images": sub.images, "labels": sub.labels}

    def epoch_batches(self, epoch: int, start: int = 0
                      ) -> Iterator[Tuple[int, Dict[str, np.ndarray]]]:
        for b in range(start, self.num_batches):
            yield b, self.batch_at(epoch, b)
