"""FedAvg and the FedAsync mix over whole parameter trees, one kernel
launch per tree; and the exact int64 coefficient fold.

``average_rows``/``fedavg_tree`` and ``fedavg_mix_tree`` flatten every
float leaf into one ``(E, N)`` float32 buffer (E updates, N parameters in
all), make a single ``fedavg_agg`` or ``fedavg_agg_mix`` launch, and split
the result back into leaves. Unlike the reference (``PALLAS_MIN_LEAF``,
one launch per leaf), no size threshold sends a small leaf to the plain
version: on the card every leaf goes through the kernel; the plain
version serves the CPU.

The coefficient form folds in int64 fixed point: each update contributes

    term_i = rint(c_i * float64(float32(x_i)) * 2**40)   (int64)

and a fold over any subset of updates is an exact int64 sum, associative
and commutative, so a partial fold composes bit-exactly with the flat
fold whatever the partition. ``coeff_finalize_tree`` converts back:
``out = float32(keep * g + acc * 2**-40)``. Every step is an eager,
separately rounded torch op in float64 (``torch.round`` rounds half to
even, as ``np.rint``), so the fold gives the reference's bits on the CPU
and on the card alike. Range: int64 is safe while |c_i x_i| < 2**22.
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence

import torch

from repro_torch.kernels.fedavg_agg.fedavg_agg import (fedavg_agg,
                                                       fedavg_agg_mix)
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten_like

Params = Any

COEFF_SCALE = float(2.0 ** 40)


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


def fedavg_mix_tree(global_tree: Params, update_trees: Sequence[Params],
                    coeffs: Sequence[float], *,
                    use_kernel: Optional[bool] = None) -> Params:
    """Batched FedAsync mix of E update trees into the global tree:

        new = (1 - sum(c)) * global + sum_i c_i * update_i

    ``coeffs`` are effective mixing coefficients (staleness-scaled and
    sequential-equivalent, see ``AsyncAggregator.flush_coeffs``). Float
    leaves go through one ``fedavg_agg_mix`` launch for the whole tree and
    keep their dtype; non-float leaves pass through unchanged; no updates
    return the global tree."""
    if not update_trees:
        return global_tree
    leaves_g = tree_leaves(global_tree)
    idx = [i for i, g in enumerate(leaves_g) if g.is_floating_point()]
    if not idx:
        return global_tree
    sizes = [leaves_g[i].numel() for i in idx]
    g = torch.cat([leaves_g[i].reshape(-1).float() for i in idx])
    stacked = torch.empty(len(update_trees), g.numel(), dtype=torch.float32,
                          device=g.device)
    for e, tree in enumerate(update_trees):
        leaves_u = tree_leaves(tree)
        torch.cat([leaves_u[i].reshape(-1).float() for i in idx],
                  out=stacked[e])
    mixed = fedavg_agg_mix(g, stacked, coeffs, use_kernel=use_kernel)
    out = list(leaves_g)
    for i, flat in zip(idx, mixed.split(sizes)):
        out[i] = flat.reshape(leaves_g[i].shape).to(leaves_g[i].dtype)
    return tree_unflatten_like(global_tree, out)


# -- coefficient-form exact fold (hierarchical aggregation) -----------------

def coeff_term_tree(tree: Params, coeff: float) -> Params:
    """One update's fixed-point contribution: int64 per float leaf, on
    the leaf's device; non-float leaves (step counters) collapse to a
    scalar 0 so the accumulator tree stays cheap to merge and ship."""
    c = float(coeff)

    def term(x):
        if not x.is_floating_point():
            return torch.zeros((), dtype=torch.int64, device=x.device)
        return torch.round(x.float().double() * c * COEFF_SCALE).to(
            torch.int64)
    return tree_map(term, tree)


def coeff_merge_trees(accs: Sequence[Optional[Params]]) -> Optional[Params]:
    """Exact merge of int64 accumulator trees (the root fold): int64
    addition is associative, so any merge order or partition gives the
    same bits. ``None`` entries (empty partials) are skipped; ``None``
    if nothing is left."""
    accs = [a for a in accs if a is not None]
    if not accs:
        return None
    out = accs[0]
    for a in accs[1:]:
        out = tree_map(torch.add, out, a)
    return out


def coeff_fold_tree(update_trees: Sequence[Params],
                    coeffs: Sequence[float]) -> Optional[Params]:
    """Fold update trees under externally supplied sequential-equivalent
    coefficients into one int64 accumulator tree; ``None`` for an empty
    fold (the caller's skipped-window path)."""
    acc = None
    for tree, c in zip(update_trees, coeffs):
        t = coeff_term_tree(tree, c)
        acc = t if acc is None else tree_map(torch.add, acc, t)
    return acc


def coeff_finalize_tree(global_tree: Params, keep: float,
                        acc: Optional[Params]) -> Params:
    """Apply a finished accumulator to the global model, per float leaf

        out = float32(keep * global + acc * 2**-40)   in the leaf's dtype

    (sync FedAvg passes keep=0; the async mix the telescoped 1 - sum(b)).
    ``acc=None`` (empty fold) carries the global forward unchanged;
    non-float leaves pass through."""
    if acc is None:
        return global_tree
    k = float(keep)

    def fin(g, a):
        if not g.is_floating_point():
            return g
        out = g.float().double() * k + a.double() / COEFF_SCALE
        return out.float().to(g.dtype)
    return tree_map(fin, global_tree, acc)
