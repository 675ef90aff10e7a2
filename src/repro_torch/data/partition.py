"""Client data partitioning: balanced / fraction-based imbalanced (the
paper gives one mobile device 20%/25%/50% of the data). A numpy copy of
``repro.data.partition``: the same seed gives the same split."""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

from repro_torch.data.datasets import ImageDataset


def balanced(ds: ImageDataset, num_clients: int, seed: int = 0
             ) -> List[ImageDataset]:
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(ds))
    return [ds.subset(part) for part in np.array_split(idx, num_clients)]


def by_fraction(ds: ImageDataset, fractions: Sequence[float], seed: int = 0
                ) -> List[ImageDataset]:
    """fractions per client, must sum to ≤ 1. Paper §V-B: the mobile device
    holds 20%/25%/50% of the total data."""
    if sum(fractions) > 1.0 + 1e-6:
        raise ValueError(f"fractions sum to {sum(fractions)} > 1")
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(ds))
    out, lo = [], 0
    for f in fractions:
        hi = lo + int(round(f * len(ds)))
        out.append(ds.subset(idx[lo:hi]))
        lo = hi
    return out

