"""Federated Averaging (McMahan et al. 2017) — the paper's aggregation,
central-server Step 5 of Fig. 1.

``fedavg`` packs the E merged client models into one ``(E, N)`` buffer
and averages it with one ``fedavg_agg`` launch per round barrier on the
card (the plain version on the CPU), then splits the result back into
leaves. Weights are client dataset sizes, normalized on the host.
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence

from repro_torch.kernels.fedavg_agg import ops as agg_ops
from repro_torch.kernels.fedavg_agg.ref import normalize_weights
from repro_torch.tree import tree_leaves, tree_unflatten_like

Params = Any

__all__ = ["normalize_weights", "fedavg"]


def fedavg(param_trees: List[Params], weights: Sequence[float], *,
           use_kernel: Optional[bool] = None) -> Params:
    """Weighted average of a list of identical-structure trees."""
    if not param_trees or len(param_trees) != len(weights):
        raise ValueError("fedavg: one weight per (non-empty list of) trees")
    rows = [tree_leaves(t) for t in param_trees]
    return tree_unflatten_like(
        param_trees[0],
        agg_ops.average_rows(rows, weights, use_kernel=use_kernel))
