"""Plain version of the WKV6 kernel: the per-token loop of
``repro.kernels.wkv6.ref.wkv6_ref`` in torch.

State S_t in R^{K x V} per head; per token t with r_t, k_t in R^K,
v_t in R^V, data-dependent decay w_t in (0, 1)^K and bonus u in R^K:

    y_t = r_t · (S_t + u ⊙ k_t v_tᵀ)
    S_{t+1} = diag(w_t) S_t + k_t v_tᵀ

Shapes: r/k/w (B, T, H, K); v (B, T, H, V); u (H, K); state0
(B, H, K, V) or None (zero). Returns (y (B, T, H, V) in r's dtype,
final state (B, H, K, V) float32).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def wkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor,
             state0: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    B, T, H, K = r.shape
    V = v.shape[-1]
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
    uf = u.float()[None, :, :, None]
    S = (torch.zeros((B, H, K, V), dtype=torch.float32, device=r.device)
         if state0 is None else state0.float())
    ys = []
    for t in range(T):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]       # (B,H,K,V)
        ys.append(torch.einsum("bhk,bhkv->bhv", rf[:, t], S + uf * kv))
        S = S * wf[:, t, :, :, None] + kv
    y = (torch.stack(ys, dim=1) if ys
         else torch.zeros((B, 0, H, V), dtype=torch.float32, device=r.device))
    return y.to(r.dtype), S
