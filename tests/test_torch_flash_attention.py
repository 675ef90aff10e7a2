"""The port's flash-attention plain version and prefill ``attention``
against the JAX package, on the same numpy inputs.

The JAX Pallas flash kernel itself does not run on the installed JAX
(``pl.load`` is gone), so the oracle is the reference's
``attention_ref``, and ``layers.attention`` on both its paths: the
materialised softmax and, above ``BLOCKED_ATTN_THRESHOLD`` keys, the
blocked online-softmax scan.

Tolerances: fp32 atol = rtol = 1e-5 (the same function, summed in
another order); bf16 2e-2 (inputs rounded to bf16 alike, outputs rounded
to bf16 by each package); the model-level attention, with its
projections, RMSNorm and RoPE, 1e-5 on the materialised path and 2e-5
through the blocked scan (4100 keys summed in blocks of 1024).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as RefConfig
from repro.kernels.flash_attention import attention_ref as jax_attention_ref
from repro.models import layers as jax_layers
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import native
from repro_torch.kernels.flash_attention.flash_attention import \
    flash_attention_fwd
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models import layers

# B, H, KV, S, T, hd, causal, window, softcap, dtype
CASES = [
    # the shapes of tests/test_kernels.py's FLASH_CASES
    (1, 4, 4, 128, 128, 64, True, 0, 0.0, "float32"),
    (2, 8, 2, 256, 256, 64, True, 0, 0.0, "float32"),
    (1, 4, 4, 128, 128, 64, True, 32, 0.0, "float32"),
    (1, 4, 4, 128, 128, 64, True, 0, 50.0, "float32"),
    (2, 2, 2, 96, 96, 32, True, 0, 0.0, "float32"),
    (1, 8, 8, 128, 128, 128, True, 0, 0.0, "bfloat16"),
    (1, 2, 1, 64, 64, 64, True, 16, 30.0, "float32"),
    # GQA rep 2 and 4
    (2, 8, 4, 128, 128, 128, True, 0, 0.0, "float32"),
    (1, 16, 4, 96, 96, 64, True, 0, 0.0, "float32"),
    # S not a multiple of 64
    (2, 4, 2, 100, 100, 64, True, 0, 0.0, "float32"),
    # non-causal, T != S (shorter and longer)
    (1, 4, 2, 80, 112, 64, False, 0, 0.0, "float32"),
    (1, 4, 4, 130, 70, 64, False, 0, 0.0, "float32"),
    # window and softcap 50, unaligned
    (1, 4, 2, 150, 150, 64, True, 40, 50.0, "float32"),
    # non-causal window, T < S: late rows see no key (uniform average)
    (1, 2, 2, 120, 50, 64, False, 16, 50.0, "float32"),
    (2, 8, 4, 72, 72, 128, True, 0, 0.0, "bfloat16"),
]


def _inputs(B, H, KV, S, T, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, S, hd)).astype(np.float32),
            rng.standard_normal((B, KV, T, hd)).astype(np.float32),
            rng.standard_normal((B, KV, T, hd)).astype(np.float32))


@pytest.mark.parametrize(
    "B,H,KV,S,T,hd,causal,window,cap,dt", CASES,
    ids=[f"B{c[0]}H{c[1]}KV{c[2]}S{c[3]}T{c[4]}hd{c[5]}"
         f"{'c' if c[6] else 'nc'}w{c[7]}cap{c[8]:g}{c[9]}" for c in CASES])
def test_plain_version_matches_attention_ref(B, H, KV, S, T, hd, causal,
                                             window, cap, dt):
    q, k, v = _inputs(B, H, KV, S, T, hd, seed=S * 31 + T)
    want = jax_attention_ref(
        *(jnp.asarray(a).astype(dt) for a in (q, k, v)), causal=causal,
        window=window, softcap=cap)
    tdt = getattr(torch, dt)
    got = flash_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                          causal=causal, window=window, softcap=cap)
    assert got.dtype == tdt and got.shape == (B, H, S, hd)
    tol = 2e-2 if dt == "bfloat16" else 1e-5
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=tol, rtol=tol)


def test_cpu_tensors_take_the_plain_version_and_refuse_the_kernel():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 2, 1, 8, 8, 32, 0))
    before = native.LAUNCHES["flash_attention"]
    assert torch.equal(flash_attention_fwd(q, k, v),
                       attention_ref(q, k, v))
    assert native.LAUNCHES["flash_attention"] == before
    with pytest.raises(ValueError):
        flash_attention_fwd(q, k, v, use_kernel=True)


def test_entry_refuses_inputs_that_ask_for_a_gradient():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 2, 1, 8, 8, 32, 0))
    with pytest.raises(NotImplementedError):
        flash_attention(q.requires_grad_(), k, v)


def _attn_cfg(**kw):
    base = dict(name="attn", family="dense", num_layers=1, d_model=128,
                num_heads=4, num_kv_heads=2, head_dim=64, d_ff=256,
                vocab_size=64, qk_norm=True)
    base.update(kw)
    return RefConfig(**base), ModelConfig(**base)


def _attn_params(cfg, seed):
    rng = np.random.default_rng(seed)
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dense = lambda i, o: (rng.standard_normal((i, o)) / np.sqrt(i)
                          ).astype(np.float32)
    p = {"wq": dense(d, H * hd), "wk": dense(d, KV * hd),
         "wv": dense(d, KV * hd), "wo": dense(H * hd, d)}
    if cfg.qk_norm:
        p["q_norm"] = {"scale": rng.uniform(0.5, 1.5, hd).astype(np.float32)}
        p["k_norm"] = {"scale": rng.uniform(0.5, 1.5, hd).astype(np.float32)}
    return p


def _run_both(ref_cfg, cfg, B, S, window, seed, tol):
    p = _attn_params(cfg, seed)
    x = np.random.default_rng(seed + 1).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    want = jax_layers.attention(
        {k: (jnp.asarray(v) if not isinstance(v, dict) else
             {"scale": jnp.asarray(v["scale"])}) for k, v in p.items()},
        ref_cfg, jnp.asarray(x), positions=jnp.asarray(pos),
        window=jnp.int32(window))
    tp = {k: (torch.from_numpy(v) if not isinstance(v, dict) else
              {"scale": torch.from_numpy(v["scale"])}) for k, v in p.items()}
    got, k, v = layers.attention(tp, cfg, torch.from_numpy(x),
                                 positions=torch.from_numpy(pos.copy()),
                                 window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                               rtol=tol)
    assert k.shape == v.shape == (B, S, cfg.num_kv_heads, cfg.head_dim)


@pytest.mark.parametrize("window,cap", [(0, 0.0), (8, 0.0), (0, 50.0)])
def test_prefill_attention_matches_materialised_path(window, cap):
    ref_cfg, cfg = _attn_cfg(attn_softcap=cap)
    _run_both(ref_cfg, cfg, B=2, S=40, window=window, seed=7, tol=1e-5)


def test_prefill_attention_matches_blocked_path():
    S = jax_layers.BLOCKED_ATTN_THRESHOLD + 4
    assert S > jax_layers.BLOCKED_ATTN_THRESHOLD
    ref_cfg, cfg = _attn_cfg(d_model=64, num_heads=2, num_kv_heads=1,
                             head_dim=32, qk_norm=False)
    _run_both(ref_cfg, cfg, B=1, S=S, window=0, seed=11, tol=2e-5)
