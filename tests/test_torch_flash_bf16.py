"""The bf16 mode of flash attention on the CPU: the port's plain version
against the JAX package, an emulation of the tensor-core kernel's
rounding points, and a bf16 prefill against the reference's own.

(a) The plain version in bf16 (``flash_attention`` on CPU tensors) against
    the reference's ``attention_ref`` in bf16 on the same numpy inputs,
    atol = rtol = 2e-2: both compute in fp32 from the same bf16 inputs and
    round the output to bf16 once, in another summation order.
(b) ``kernel_emulation`` repeats, in plain torch, where the bf16 kernel of
    ``csrc/flash_attention_mma.cu`` rounds: fp32 logits from bf16 inputs
    (a bf16·bf16 product is exact in fp32), an online softmax over 64-key
    tiles with fp32 p and l, P rounded to bf16 before P·V, O in fp32,
    rounded to bf16 once (its exp and tanh are the library's, a few fp32
    ulp from the kernel's). Held against ``attention_ref`` at the full qwen3
    head shape, within the card tolerance 2e-2 and within
    2^-9·max|v| + 2^-8·|out|: one rounding of the output (up to one bf16
    ulp apart, 2^-8 relative) plus P's rounding (2^-8·p per key at worst,
    unbiased, so a row's sum stays near 2^-9·max|v|).
(c) A reduced qwen3 prefill in bf16 against the reference's bf16 prefill
    on the same weights: the last-token logits and each cache entry (k, v)
    within 2e-2 of the tensor's max|x|, not of each element. bf16 rounds
    at other places in the two frameworks (XLA keeps some products and
    norms in fp32 where the port rounds each op's output to bf16), so two
    operands can differ by an ulp (2^-8 relative); where RoPE or a residual
    sum cancels them the result keeps that error at the operand's scale.
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import attention_ref as jax_attention_ref
from repro.launch import steps as jax_steps
from repro.models import registry as jax_registry
from repro_torch.kernels import native
from repro_torch.kernels.flash_attention.flash_attention import aligned
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import BIG_NEG
from repro_torch.launch import steps
from repro_torch.models import registry
from repro_torch.models.transformer import params_from_reference

TOL = 2e-2
CPU = torch.device("cpu")

# B, H, KV, S, T, hd, causal, window, softcap
CASES = [
    (1, 4, 4, 128, 128, 64, True, 0, 0.0),       # hd 64, rep 1
    (1, 8, 4, 100, 100, 128, True, 0, 0.0),      # hd 128, rep 2
    (1, 8, 2, 150, 150, 64, True, 32, 0.0),      # rep 4, window
    (1, 4, 2, 96, 96, 128, True, 0, 50.0),       # softcap
    (2, 8, 2, 130, 130, 64, True, 40, 30.0),     # window and softcap
    (1, 4, 2, 120, 50, 64, False, 16, 50.0),     # T < S, rows with no key
    (1, 4, 1, 70, 130, 128, False, 0, 0.0),      # non-causal, T > S
    (1, 2, 1, 90, 60, 128, False, 0, 0.0),       # non-causal, T < S
    (1, 8, 2, 1, 1, 128, True, 0, 0.0),          # one query row
]


def _inputs(B, H, KV, S, T, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, S, hd)).astype(np.float32),
            rng.standard_normal((B, KV, T, hd)).astype(np.float32),
            rng.standard_normal((B, KV, T, hd)).astype(np.float32))


def _reference(q, k, v, **kw) -> np.ndarray:
    """The JAX oracle on bf16 inputs, its bf16 output as float32."""
    out = jax_attention_ref(*(jnp.asarray(a).astype(jnp.bfloat16)
                              for a in (q, k, v)), **kw)
    return np.asarray(out.astype(jnp.float32))


def _bf16(*arrays):
    return [torch.from_numpy(a).to(torch.bfloat16) for a in arrays]


@pytest.mark.parametrize(
    "B,H,KV,S,T,hd,causal,window,cap", CASES,
    ids=[f"B{c[0]}H{c[1]}KV{c[2]}S{c[3]}T{c[4]}hd{c[5]}"
         f"{'c' if c[6] else 'nc'}w{c[7]}cap{c[8]:g}" for c in CASES])
def test_bf16_plain_version_matches_attention_ref(B, H, KV, S, T, hd, causal,
                                                  window, cap):
    q, k, v = _inputs(B, H, KV, S, T, hd, seed=S * 37 + T + hd)
    kw = dict(causal=causal, window=window, softcap=cap)
    before = dict(native.LAUNCHES)
    got = flash_attention(*_bf16(q, k, v), **kw)
    assert native.LAUNCHES == before       # CPU tensors: the plain version
    assert got.dtype == torch.bfloat16 and got.shape == (B, H, S, hd)
    np.testing.assert_allclose(got.float().numpy(), _reference(q, k, v, **kw),
                               atol=TOL, rtol=TOL)


def kernel_emulation(q, k, v, *, causal=True, window=0, softcap=0.0,
                     block=64):
    """The bf16 kernel's arithmetic in plain torch: q (B, H, S, hd), k/v
    (B, KV, T, hd) bf16 -> (B, H, S, hd) bf16. Every row walks all key
    tiles; a tile the kernel skips holds only masked keys for that row,
    whose p and contribution the next real key's exp(m_old - m_new) = 0
    removes, so the result is the kernel's."""
    B, H, S, hd = q.shape
    KV, T = k.shape[1], k.shape[2]
    rep = H // KV
    qf = q.float().reshape(B, KV, rep, S, hd)
    kf, vf = k.float(), v.float()
    rows = torch.arange(S)[:, None]
    o = torch.zeros((B, KV, rep, S, hd))
    m = torch.full((B, KV, rep, S, 1), BIG_NEG)
    l = torch.zeros((B, KV, rep, S, 1))
    for k0 in range(0, T, block):
        kt, vt = kf[:, :, k0:k0 + block], vf[:, :, k0:k0 + block]
        s = torch.einsum("bgrsh,bgth->bgrst", qf, kt) * (1.0 / math.sqrt(hd))
        if softcap > 0:
            s = softcap * torch.tanh(s / softcap)
        dist = rows - torch.arange(k0, k0 + kt.shape[2])[None, :]
        ok = torch.ones_like(dist, dtype=torch.bool)
        if causal:
            ok &= dist >= 0
        if window > 0:
            ok &= dist < window
        s = s.masked_fill(~ok, BIG_NEG)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)                       # fp32
        l = l * corr + p.sum(-1, keepdim=True)         # from the fp32 p
        pb = p.to(torch.bfloat16).float()              # P rounded to bf16
        o = o * corr + torch.einsum("bgrst,bgth->bgrsh", pb, vt)
        m = m_new
    out = o / torch.clamp(l, min=1e-30)
    return out.reshape(B, H, S, hd).to(torch.bfloat16)


# B, H, KV, S, hd, window, softcap: one qwen3-0.6b layer's heads at prompt
# 1024 (the chip's main shape at batch 1), and a windowed softcapped hd 64
EMULATED = [(1, 16, 8, 1024, 128, 0, 0.0), (1, 8, 2, 1000, 64, 256, 50.0)]


@pytest.mark.parametrize("B,H,KV,S,hd,window,cap", EMULATED,
                         ids=["qwen3-layer", "hd64-window-softcap"])
def test_kernel_rounding_points_fit_the_bf16_tolerance(B, H, KV, S, hd,
                                                       window, cap):
    q, k, v = _inputs(B, H, KV, S, S, hd, seed=S + hd)
    kw = dict(causal=True, window=window, softcap=cap)
    want = _reference(q, k, v, **kw)
    qb, kb, vb = _bf16(q, k, v)
    got = kernel_emulation(qb, kb, vb, **kw).float().numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    err = np.abs(got - want)
    bound = (2.0 ** -9 * float(vb.float().abs().max())
             + 2.0 ** -8 * np.abs(want))
    assert (err <= bound).all(), float((err - bound).max())
    # the rounding of P is real: without it the emulation moves
    assert not np.array_equal(got, flash_attention(qb, kb, vb, **kw)
                              .float().numpy())


def test_misaligned_views_are_copied_aligned():
    flat = torch.arange(65, dtype=torch.bfloat16)
    view = flat[1:].view(1, 1, 1, 64)
    assert view.is_contiguous() and view.data_ptr() % 16
    fixed = aligned(view)
    assert fixed.data_ptr() % 16 == 0 and torch.equal(fixed, view)
    whole = flat[:64]
    assert aligned(whole) is whole


def test_bf16_prefill_matches_reference_bf16_prefill():
    bf = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    ref_cfg = jax_registry.make_reduced(
        jax_registry.get_config("qwen3-0.6b")).replace(**bf)
    cfg = registry.make_reduced(
        registry.get_config("qwen3-0.6b")).replace(**bf)
    ref_model = jax_registry.build_model(ref_cfg)
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    model = registry.build_model(cfg, device=CPU)
    model.load_params(params_from_reference(jax.tree.map(
        lambda a: np.asarray(a.astype(jnp.float32)), ref_params), CPU))
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    tokens = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 80)).astype(np.int32)
    want_logits, want_aux = jax.jit(jax_steps.make_prefill_step(ref_model))(
        ref_params, {"tokens": jnp.asarray(tokens)})
    logits, aux = steps.make_prefill_step(model)(
        {"tokens": torch.from_numpy(tokens)})
    want = np.asarray(want_logits, np.float32)
    got = logits.float().numpy()
    assert got.shape == want.shape == (2, 1, cfg.vocab_size)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()
    assert sorted(aux) == sorted(want_aux)
    for key in want_aux:
        assert aux[key].dtype == torch.bfloat16, key
        want = np.asarray(want_aux[key].astype(jnp.float32))
        assert (np.abs(aux[key].float().numpy() - want).max()
                <= TOL * np.abs(want).max()), key
