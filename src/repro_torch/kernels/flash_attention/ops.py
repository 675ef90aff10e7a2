"""Model-facing entry of the flash-attention kernel.

``repro.kernels.flash_attention.ops`` pads S/T to the Pallas kernel's
blocks and wraps it in a ``custom_vjp``. The CUDA kernel takes any S and
T itself, and the port serves only: its backward comes with LLM training
(ROADMAP.md). So this entry is the forward alone, and it refuses inputs
that ask for a gradient rather than return one autograd cannot carry.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.flash_attention import \
    flash_attention_fwd


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0,
                    use_kernel: Optional[bool] = None) -> torch.Tensor:
    """q: (B, H, S, hd); k/v: (B, KV, T, hd) -> (B, H, S, hd)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention has no backward yet (ROADMAP.md: the flash "
            "backward comes with LLM training)")
    return flash_attention_fwd(q, k, v, causal=causal, window=window,
                               softcap=softcap, use_kernel=use_kernel)
