"""Plain version of the flash-attention kernel: materialised
causal / sliding-window GQA attention with an fp32 softmax, the torch
copy of ``repro.kernels.flash_attention.ref.attention_ref``.

Shapes follow the kernel: q (B, H, S, hd), k/v (B, KV, T, hd), H = KV·rep;
query row s and key t sit at positions s and t. Masked logits are
``BIG_NEG`` (the reference's value), so a row whose every key is masked
averages all T keys, as the reference does.
"""
from __future__ import annotations

import math

import torch

BIG_NEG = -2.3819763e38


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  softcap: float = 0.0) -> torch.Tensor:
    B, H, S, hd = q.shape
    KV, T = k.shape[1], k.shape[2]
    rep = H // KV
    qg = q.reshape(B, KV, rep, S, hd).float()
    logits = torch.einsum("bgrsh,bgth->bgrst", qg, k.float()) \
        / math.sqrt(hd)
    if softcap and softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    dist = (torch.arange(S, device=q.device)[:, None]
            - torch.arange(T, device=q.device)[None, :])
    ok = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        ok = ok & (dist >= 0)
    if window and window > 0:
        ok = ok & (dist < window)
    logits = logits.masked_fill(~ok, BIG_NEG)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bgrst,bgth->bgrsh", w, v.float())
    return out.reshape(B, H, S, hd).to(q.dtype)
