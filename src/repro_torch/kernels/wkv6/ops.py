"""Model-facing entry of the WKV6 kernel.

``repro.kernels.wkv6.ops.wkv6`` picks the chunked Pallas kernel when T
divides by the chunk and the oracle otherwise. The CUDA kernel takes any
T, so this entry has no such choice; like the flash-attention entry it
serves only, and refuses inputs that ask for a gradient (the kernel has
no backward).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.wkv6.wkv6 import wkv6 as wkv6_kernel


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         w: torch.Tensor, u: torch.Tensor,
         state0: Optional[torch.Tensor] = None, *,
         use_kernel: Optional[bool] = None
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r/k/w: (B, T, H, K); v: (B, T, H, V); u: (H, K) ->
    (y (B, T, H, V), final state (B, H, K, V))."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (r, k, v, w, u)):
        raise NotImplementedError(
            "wkv6 has no backward yet (ROADMAP.md: RWKV training)")
    return wkv6_kernel(r, k, v, w, u, state0, use_kernel=use_kernel)
