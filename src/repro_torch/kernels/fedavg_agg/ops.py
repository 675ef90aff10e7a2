"""FedAvg over whole parameter trees, one kernel launch per tree.

Every leaf is flattened into one ``(E, N)`` float32 buffer (E clients,
N parameters in all), averaged by a single ``fedavg_agg`` launch, and
split back into leaves. Unlike the reference (``PALLAS_MIN_LEAF``), no
size threshold sends a small leaf to the plain version: on the card every
leaf goes through the kernel; the plain version serves the CPU.
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence

import torch

from repro_torch.kernels.fedavg_agg.fedavg_agg import fedavg_agg
from repro_torch.tree import tree_leaves, tree_unflatten_like

Params = Any


def average_rows(rows: Sequence[Sequence[torch.Tensor]], weights, *,
                 use_kernel: Optional[bool] = None) -> List[torch.Tensor]:
    """``rows[e]`` is client e's list of leaves (same shapes across e).
    Returns the weighted-average leaves, views of one result buffer."""
    first = rows[0]
    dtypes = {t.dtype for t in first}
    if len(dtypes) != 1:
        raise ValueError(f"fedavg: leaves of one dtype expected, got {dtypes}")
    sizes = [t.numel() for t in first]
    stacked = torch.empty(len(rows), sum(sizes), dtype=first[0].dtype,
                          device=first[0].device)
    for e, leaves in enumerate(rows):
        torch.cat([t.reshape(-1) for t in leaves], out=stacked[e])
    out = fedavg_agg(stacked, weights, use_kernel=use_kernel)
    return [flat.reshape(t.shape)
            for flat, t in zip(out.split(sizes), first)]


def fedavg_tree(stacked_tree: Params, weights, *,
                use_kernel: Optional[bool] = None) -> Params:
    """Every leaf has leading axis E; returns the weighted-average tree."""
    leaves = tree_leaves(stacked_tree)
    E = leaves[0].shape[0]
    rows = [[leaf[e] for leaf in leaves] for e in range(E)]
    return tree_unflatten_like(
        stacked_tree, average_rows(rows, weights, use_kernel=use_kernel))
