"""Core layers of the dense and RWKV families: norms, RoPE, GQA attention
(prefill through the flash-attention kernel, decode against a
ring-buffered KV cache) and the SwiGLU MLP.

The torch counterpart of ``repro.models.layers``. Every function takes
the reference's parameter layout: a dict of tensors with projections
stored ``(d_in, d_out)``, applied as ``x @ w``. The sharding ``hint``s of
the reference are dropped until the SPMD slice.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention.ops import flash_attention

Params = Dict[str, Any]

BIG_NEG = -2.3819763e38  # most-negative bf16, the reference's mask value


# ---------------------------------------------------------------------------
# initializers (the reference's scheme; torch and JAX draw different
# numbers from one seed, so tests carry the reference's parameters over)
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype) -> torch.Tensor:
    w = torch.randn((d_in, d_out), generator=gen, device=gen.device)
    return (w * (1.0 / math.sqrt(d_in))).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype: torch.dtype) -> torch.Tensor:
    return (torch.randn((vocab, d), generator=gen, device=gen.device)
            * 0.02).to(dtype)


def rmsnorm_init(d: int, dtype: torch.dtype, device) -> Params:
    return {"scale": torch.ones(d, dtype=dtype, device=device)}


def layernorm_init(d: int, dtype: torch.dtype, device) -> Params:
    return {"scale": torch.ones(d, dtype=dtype, device=device),
            "bias": torch.zeros(d, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm(params: Params, x: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return (xf * params["scale"].float()).to(dt)


def layernorm(params: Params, x: torch.Tensor, eps: float = 1e-6
              ) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    xf = (xf - mu) * torch.rsqrt(var + eps)
    return (xf * params["scale"].float() + params["bias"].float()).to(dt)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (..., S) integer."""
    hd = x.shape[-1]
    half = hd // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freq = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                  device=x.device), exps)
    angles = positions[..., None].float() * freq         # (..., S, half)
    cos = torch.cos(angles)[..., None, :]                # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def attention_init(gen: torch.Generator, cfg, dtype: torch.dtype) -> Params:
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {"wq": dense_init(gen, d, H * hd, dtype),
         "wk": dense_init(gen, d, KV * hd, dtype),
         "wv": dense_init(gen, d, KV * hd, dtype),
         "wo": dense_init(gen, H * hd, d, dtype)}
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(hd, dtype, gen.device)
        p["k_norm"] = rmsnorm_init(hd, dtype, gen.device)
    return p


def _softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    if cap and cap > 0:
        return cap * torch.tanh(logits / cap)
    return logits


def attention(params: Params, cfg, x: torch.Tensor, *,
              positions: torch.Tensor, window: int,
              use_kernel: Optional[bool] = None):
    """Causal GQA self-attention over a prefill (the sequence starts at
    position 0, so the kernel masks by sequence index).

    x: (B, S, d); positions: (B, S) (RoPE); window: 0 = full attention.
    Returns ``(out (B, S, d), k, v)``: k (after qk-norm and RoPE) and v
    as (B, S, KV, hd) are the prefill's cache entries (the reference
    returns ``out`` alone and recomputes them). The reference switches
    from a materialised softmax to a blocked scan above 4096 keys; all
    three compute one function, and here every S goes through
    ``flash_attention`` (the kernel for a CUDA tensor).
    """
    B, S, _ = x.shape
    H, KVh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (x @ params["wq"]).reshape(B, S, H, hd)
    k = (x @ params["wk"]).reshape(B, S, KVh, hd)
    v = (x @ params["wv"]).reshape(B, S, KVh, hd)
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(params["k_norm"], k, cfg.norm_eps)
    if cfg.rope_theta > 0:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=True, window=int(window),
                          softcap=cfg.attn_softcap, use_kernel=use_kernel)
    out = out.transpose(1, 2).reshape(B, S, H * hd).to(x.dtype)
    return (out @ params["wo"]).to(x.dtype), k, v


def decode_attention(params: Params, cfg, x: torch.Tensor, *, pos: int,
                     cache_k: torch.Tensor, cache_v: torch.Tensor,
                     cache_positions: torch.Tensor,
                     window: int) -> torch.Tensor:
    """Single-token decode against a (ring-buffered) KV cache.

    x: (B, 1, d); pos: the current position. cache_k/v: (B, C, KV, hd);
    cache_positions: (B, C) int32 (-1 = empty). The new token's k, v and
    position are written into the cache **in place** at its slot (a
    decode session owns its cache; a copy of every layer's cache per
    token would dominate the step's memory traffic). Returns (B, 1, d).
    The reference computes this outside any Pallas kernel, and so does
    the port: one query against the cache is plain PyTorch.
    """
    B, S, _ = x.shape
    KVh, hd = cfg.num_kv_heads, cfg.head_dim
    C = cache_k.shape[1]

    k = (x @ params["wk"]).reshape(B, S, KVh, hd)
    v = (x @ params["wv"]).reshape(B, S, KVh, hd)
    if cfg.qk_norm:
        k = rmsnorm(params["k_norm"], k, cfg.norm_eps)
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    if cfg.rope_theta > 0:
        k = rope(k, positions, cfg.rope_theta)

    slot = pos % max(C, 1) if window > 0 else pos
    slot = min(slot, C - 1)
    cache_k[:, slot] = k[:, 0].to(cache_k.dtype)
    cache_v[:, slot] = v[:, 0].to(cache_v.dtype)
    cache_positions[:, slot] = pos

    q = (x @ params["wq"]).reshape(B, S, cfg.num_heads, hd)
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q, cfg.norm_eps)
    if cfg.rope_theta > 0:
        q = rope(q, positions, cfg.rope_theta)

    rep = cfg.num_heads // KVh
    q = q.reshape(B, S, KVh, rep, hd)
    logits = torch.einsum("bsgrh,btgh->bgrst", q.float(), cache_k.float())
    logits = logits / math.sqrt(hd)
    logits = _softcap(logits, cfg.attn_softcap)
    lg = logits.reshape(B, KVh * rep, S, C)
    dist = pos - cache_positions                              # (B, C)
    ok = (cache_positions >= 0) & (dist >= 0)
    if window > 0:
        ok = ok & (dist < window)
    lg = lg.masked_fill(~ok[:, None, None, :], BIG_NEG)
    w = torch.softmax(lg, dim=-1).to(x.dtype).reshape(B, KVh, rep, S, C)
    out = torch.einsum("bgrst,btgh->bsgrh", w, cache_v.to(x.dtype))
    out = out.reshape(B, S, cfg.num_heads * hd)
    return (out @ params["wo"]).to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (SwiGLU)
# ---------------------------------------------------------------------------

def mlp_init(gen: torch.Generator, d: int, f: int, dtype: torch.dtype
             ) -> Params:
    return {"wi_gate": dense_init(gen, d, f, dtype),
            "wi_up": dense_init(gen, d, f, dtype),
            "wo": dense_init(gen, f, d, dtype)}


def mlp(params: Params, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ params["wi_gate"]) * (x @ params["wi_up"])
    return (h @ params["wo"]).to(x.dtype)
