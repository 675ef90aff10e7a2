"""Federated Averaging (McMahan et al. 2017) — the paper's aggregation,
central-server Step 5 of Fig. 1.

``fedavg`` packs the E merged client models into one ``(E, N)`` buffer
and averages it with one ``fedavg_agg`` launch per round barrier on the
card (the plain version on the CPU), then splits the result back into
leaves. Weights are client dataset sizes, normalized on the host.

``fedavg_stacked``, ``broadcast_stacked`` and ``tree_weighted_delta`` are
plain torch, as the reference computes them outside any kernel.
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence

from repro_torch.kernels.fedavg_agg import ops as agg_ops
from repro_torch.kernels.fedavg_agg.ref import normalize_weights
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten_like

Params = Any

__all__ = ["normalize_weights", "fedavg", "fedavg_stacked",
           "broadcast_stacked", "tree_weighted_delta"]


def fedavg(param_trees: List[Params], weights: Sequence[float], *,
           use_kernel: Optional[bool] = None) -> Params:
    """Weighted average of a list of identical-structure trees."""
    if not param_trees or len(param_trees) != len(weights):
        raise ValueError("fedavg: one weight per (non-empty list of) trees")
    rows = [tree_leaves(t) for t in param_trees]
    return tree_unflatten_like(
        param_trees[0],
        agg_ops.average_rows(rows, weights, use_kernel=use_kernel))


def fedavg_stacked(stacked: Params, weights) -> Params:
    """stacked: every leaf has leading axis E (edges or clients);
    weights: (E,) unnormalized. Returns the weighted-average tree, each
    leaf in its own dtype (float32 arithmetic)."""
    w = normalize_weights(weights)

    def avg(leaf):
        wf = w.to(leaf.device).reshape((-1,) + (1,) * (leaf.dim() - 1))
        return (leaf.float() * wf).sum(0).to(leaf.dtype)
    return tree_map(avg, stacked)


def broadcast_stacked(tree: Params, num: int) -> Params:
    """Replicate a global tree onto a leading edge axis (Step 6 of
    Fig. 1). The leaves are expanded views of ``tree``'s: no copy, and
    not to be written in place."""
    return tree_map(lambda x: x.unsqueeze(0).expand((num,) + tuple(x.shape)),
                    tree)


def tree_weighted_delta(new: Params, old: Params) -> Params:
    """new - old, in float32 (the delta-codec migration payloads)."""
    return tree_map(lambda a, b: a.float() - b.float(), new, old)
