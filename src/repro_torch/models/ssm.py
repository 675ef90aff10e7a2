"""RWKV6 ("Finch") time mixing: data-dependent-decay WKV, attention-free.

The torch counterpart of the RWKV part of ``repro.models.ssm`` (the Mamba
part waits for the hybrid arch). A prefill (``rwkv_scan``) computes the
token shift and the r/k/v/w/g projections over the whole sequence at
once, as the reference's ``rwkv_scan_chunked`` does, and runs the
recurrence through the ``wkv6`` kernel (its plain version on the CPU).
Decode steps the same math one token at a time on a carried state
(``rwkv_cell``), so the state is part of a migrated decode session.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.wkv6.ops import wkv6
from repro_torch.models import layers

Params = Dict[str, Any]

RWKV_HEAD = 64


def rwkv_init(gen: torch.Generator, cfg, dtype: torch.dtype) -> Params:
    d = cfg.d_model
    H = d // RWKV_HEAD
    lora = max(32, d // 32)
    dev = gen.device
    return {
        # token-shift mixing coefficients for r, k, v, w, g
        "mu": torch.full((5, d), 0.5, dtype=dtype, device=dev),
        "w_r": layers.dense_init(gen, d, d, dtype),
        "w_k": layers.dense_init(gen, d, d, dtype),
        "w_v": layers.dense_init(gen, d, d, dtype),
        "w_g": layers.dense_init(gen, d, d, dtype),
        "w_o": layers.dense_init(gen, d, d, dtype),
        # data-dependent decay: w_t = exp(-exp(w0 + tanh(x A) B))
        "decay_w0": torch.full((d,), -6.0, dtype=dtype, device=dev),
        "decay_A": layers.dense_init(gen, d, lora, dtype),
        "decay_B": layers.dense_init(gen, lora, d, dtype),
        "bonus_u": (torch.randn((H, RWKV_HEAD), generator=gen, device=dev)
                    * 0.1).to(dtype),
        "ln_out": layers.layernorm_init(d, dtype, dev),
    }


def _rwkv_mix(params: Params, x: torch.Tensor, xprev: torch.Tensor):
    """Token-shift interpolation for the five streams (xr, xk, xv, xw,
    xg)."""
    mu = params["mu"].to(x.dtype)
    return [x + (xprev - x) * mu[i] for i in range(5)]


def rwkv_decay(params: Params, xw: torch.Tensor) -> torch.Tensor:
    """Data-dependent per-channel decay in (0, 1): the RWKV6 signature."""
    lora = torch.tanh(xw @ params["decay_A"]) @ params["decay_B"]
    logw = params["decay_w0"].float() + lora.float()
    return torch.exp(-torch.exp(logw))


def rwkv_cell(params: Params, cfg, state: torch.Tensor, xt: torch.Tensor,
              xprev_t: torch.Tensor):
    """One WKV6 step. state: (B, H, K, V) fp32; xt/xprev_t: (B, d).
    Returns (new_state, y (B, d))."""
    B, d = xt.shape
    H = d // RWKV_HEAD
    xr, xk, xv, xw, xg = _rwkv_mix(params, xt, xprev_t)
    r = (xr @ params["w_r"]).reshape(B, H, RWKV_HEAD).float()
    k = (xk @ params["w_k"]).reshape(B, H, RWKV_HEAD).float()
    v = (xv @ params["w_v"]).reshape(B, H, RWKV_HEAD).float()
    g = F.silu(xg @ params["w_g"])
    w = rwkv_decay(params, xw).reshape(B, H, RWKV_HEAD)
    u = params["bonus_u"].float()

    kv = k[..., :, None] * v[..., None, :]                  # (B, H, K, V)
    y = torch.einsum("bhk,bhkv->bhv", r, state + u[None, :, :, None] * kv)
    new_state = state * w[..., None] + kv
    y = y.reshape(B, d).to(xt.dtype)
    y = layers.layernorm(params["ln_out"], y, cfg.norm_eps) * g
    return new_state, y @ params["w_o"]


def rwkv_scan(params: Params, cfg, x: torch.Tensor,
              state0: Optional[torch.Tensor] = None,
              xprev0: Optional[torch.Tensor] = None, *,
              use_kernel: Optional[bool] = None):
    """x: (B, S, d) -> (y (B, S, d), (final_state (B, H, 64, 64) fp32,
    last_x (B, d)))."""
    B, S, d = x.shape
    H, K = d // RWKV_HEAD, RWKV_HEAD
    if xprev0 is None:
        xprev0 = torch.zeros((B, d), dtype=x.dtype, device=x.device)
    xprev = torch.cat([xprev0[:, None], x[:, :-1]], dim=1)
    xr, xk, xv, xw, xg = _rwkv_mix(params, x, xprev)
    r = (xr @ params["w_r"]).reshape(B, S, H, K).float()
    k = (xk @ params["w_k"]).reshape(B, S, H, K).float()
    v = (xv @ params["w_v"]).reshape(B, S, H, K).float()
    g = F.silu(xg @ params["w_g"])
    w = rwkv_decay(params, xw).reshape(B, S, H, K)
    u = params["bonus_u"].float()
    y, state = wkv6(r, k, v, w, u, state0, use_kernel=use_kernel)
    y = y.reshape(B, S, d).to(x.dtype)
    y = layers.layernorm(params["ln_out"], y, cfg.norm_eps) * g
    return y @ params["w_o"], (state, x[:, -1])
