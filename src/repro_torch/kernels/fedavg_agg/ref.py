"""Plain version of the FedAvg aggregation kernel."""
from __future__ import annotations

import torch


def normalize_weights(weights) -> torch.Tensor:
    """(E,) float32 ``w / max(sum(w), 1e-12)``, on the host (as the
    reference normalizes before its kernel)."""
    w = torch.as_tensor(weights, dtype=torch.float32).reshape(-1).cpu()
    return w / torch.clamp_min(w.sum(), 1e-12)


def fedavg_agg_ref(stacked: torch.Tensor, weights) -> torch.Tensor:
    """stacked: (E, N); weights: (E,) unnormalized -> (N,) in stacked's
    dtype. Accumulates in float32 in row order, one rounding per product
    and per sum — the order of ``repro.core.fedavg.fedavg``."""
    w = normalize_weights(weights).tolist()
    acc = torch.zeros(stacked.shape[1], dtype=torch.float32,
                      device=stacked.device)
    for e, we in enumerate(w):
        acc = acc + torch.full_like(acc, we) * stacked[e].float()
    return acc.to(stacked.dtype)
