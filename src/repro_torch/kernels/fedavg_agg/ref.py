"""Plain versions of the FedAvg aggregation kernels, and the flat-array
oracles of the exact coefficient fold (``ops.coeff_*``)."""
from __future__ import annotations

from typing import Tuple

import numpy as np
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


def mix_coeffs(weights) -> Tuple[np.ndarray, np.float32]:
    """(w, keep) of a mix: the coefficients as (E,) float32 and
    ``keep = 1 - sum(w)``, summed by numpy in float32 on the host exactly
    as the reference's numpy path does (``ops.py``: ``np.float32(1) -
    w.sum(dtype=np.float32)``), so kernel, plain version and reference
    share one ``keep``."""
    w = torch.as_tensor(weights, dtype=torch.float32).reshape(-1).cpu()
    w = w.numpy()
    return w, np.float32(1.0) - w.sum(dtype=np.float32)


def fedavg_agg_mix_ref(global_flat: torch.Tensor, stacked: torch.Tensor,
                       weights) -> torch.Tensor:
    """``(1 - sum(w)) * global + w @ stacked`` -> (N,) in global_flat's
    dtype; w are effective mixing coefficients (unnormalized on purpose).
    float32 throughout: the E products summed in row order, then
    ``keep * g`` added last, each product and sum rounded separately —
    the kernel's order."""
    w, keep = mix_coeffs(weights)
    acc = torch.zeros(stacked.shape[1], dtype=torch.float32,
                      device=stacked.device)
    for e, we in enumerate(w.tolist()):
        acc = acc + torch.full_like(acc, we) * stacked[e].float()
    kg = torch.full_like(acc, float(keep)) * global_flat.float()
    return (kg + acc).to(global_flat.dtype)


# -- coefficient-form exact-fold oracles (flat arrays, numpy) ---------------

_COEFF_SCALE = np.float64(2.0 ** 40)


def coeff_fold_ref(stacked: np.ndarray, coeffs: np.ndarray) -> np.ndarray:
    """stacked: (E, N) float block; coeffs: (E,) float64. Returns the
    int64 fixed-point accumulator sum_i rint(c_i * x_i * 2**40) — the
    flat-array oracle for ``ops.coeff_fold_tree``."""
    x = np.asarray(stacked).astype(np.float32).astype(np.float64)
    c = np.asarray(coeffs, np.float64)[:, None]
    return np.rint(c * x * _COEFF_SCALE).astype(np.int64).sum(axis=0)


def coeff_finalize_ref(global_flat: np.ndarray, keep: float,
                       acc: np.ndarray) -> np.ndarray:
    """float32(keep * global + acc * 2**-40) — the flat-array oracle for
    ``ops.coeff_finalize_tree``."""
    g = np.asarray(global_flat)
    out = (np.float64(keep) * g.astype(np.float32).astype(np.float64)
           + acc.astype(np.float64) / _COEFF_SCALE)
    return out.astype(np.float32).astype(g.dtype)
