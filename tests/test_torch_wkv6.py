"""The port's WKV6 plain version and RWKV time mixing against the JAX
package, on the same numpy inputs.

The oracles: ``wkv6_ref`` (the per-token scan), and the Pallas
``wkv6_chunked`` run in interpret mode as ``tests/test_kernels.py`` runs
it (only where T divides by the chunk, which the Pallas kernel needs;
the port's kernel takes any T).

Tolerances: y and the final state at atol = rtol = 1e-5 (the same
recurrence, the 64-term read-out summed in another order); the whole
``rwkv_scan`` (projections, decay LoRA, layernorm) against the
reference's at 1e-4.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as RefConfig
from repro.kernels.wkv6 import wkv6_ref as jax_wkv6_ref
from repro.kernels.wkv6.wkv6 import wkv6_chunked
from repro.models import ssm as jax_ssm
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import native
from repro_torch.kernels.wkv6.ops import wkv6
from repro_torch.kernels.wkv6.wkv6 import wkv6 as wkv6_kernel
from repro_torch.models import ssm

TOL = dict(atol=1e-5, rtol=1e-5)


def _inputs(B, T, H, K, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    r, k, v = (f(B, T, H, K) * 0.5 for _ in range(3))
    w = (1 / (1 + np.exp(-f(B, T, H, K)))) * 0.5 + 0.4
    u = f(H, K) * 0.1
    return r, k, v, w.astype(np.float32), u


def _port(*arrays):
    return [torch.from_numpy(a.copy()) for a in arrays]


# B, T, H, K, chunk (None: T is not a multiple of any chunk used)
CASES = [(1, 64, 1, 64, 64), (2, 128, 2, 64, 64), (1, 96, 1, 64, 32),
         (2, 256, 4, 64, 128), (2, 100, 3, 64, None), (1, 1, 2, 64, None),
         (1, 67, 2, 64, None)]


@pytest.mark.parametrize("B,T,H,K,chunk", CASES,
                         ids=[f"B{c[0]}T{c[1]}H{c[2]}ch{c[4]}" for c in CASES])
def test_plain_version_matches_wkv6_oracles(B, T, H, K, chunk):
    r, k, v, w, u = _inputs(B, T, H, K, seed=T * 7 + H)
    y, s = wkv6(*_port(r, k, v, w, u))
    y_ref, s_ref = jax_wkv6_ref(*(jnp.asarray(a) for a in (r, k, v, w, u)))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), **TOL)
    assert s.dtype == torch.float32 and s.shape == (B, H, K, K)
    if chunk is not None:
        y_pl, s_pl = wkv6_chunked(*(jnp.asarray(a) for a in (r, k, v, w, u)),
                                  chunk=chunk, interpret=True)
        np.testing.assert_allclose(y.numpy(), np.asarray(y_pl), **TOL)
        np.testing.assert_allclose(s.numpy(), np.asarray(s_pl), **TOL)


def test_carried_state_matches_the_oracle():
    r, k, v, w, u = _inputs(2, 48, 2, 64, seed=5)
    s0 = np.random.default_rng(6).standard_normal(
        (2, 2, 64, 64)).astype(np.float32)
    y, s = wkv6(*_port(r, k, v, w, u), torch.from_numpy(s0))
    y_ref, s_ref = jax_wkv6_ref(*(jnp.asarray(a) for a in (r, k, v, w, u)),
                                state0=jnp.asarray(s0))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), **TOL)


def test_cpu_tensors_take_the_plain_version_and_refuse_the_kernel():
    r, k, v, w, u = _port(*_inputs(1, 4, 1, 64, seed=0))
    before = native.LAUNCHES["wkv6"]
    wkv6_kernel(r, k, v, w, u)
    assert native.LAUNCHES["wkv6"] == before
    with pytest.raises(ValueError):
        wkv6_kernel(r, k, v, w, u, use_kernel=True)
    with pytest.raises(NotImplementedError):
        wkv6(r.requires_grad_(), k, v, w, u)


def _rwkv_cfg():
    base = dict(name="rwkv", family="ssm", num_layers=1, d_model=128,
                num_heads=2, num_kv_heads=2, head_dim=64, d_ff=256,
                vocab_size=64, rwkv=True, rope_theta=0.0)
    return RefConfig(**base), ModelConfig(**base)


def test_rwkv_scan_matches_reference():
    ref_cfg, cfg = _rwkv_cfg()
    params = jax.tree.map(np.asarray,
                          jax_ssm.rwkv_init(jax.random.PRNGKey(3), ref_cfg,
                                            jnp.float32))
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    xprev0 = rng.standard_normal((2, cfg.d_model)).astype(np.float32)
    y_ref, (s_ref, last_ref) = jax_ssm.rwkv_scan(
        jax.tree.map(jnp.asarray, params), ref_cfg, jnp.asarray(x),
        xprev0=jnp.asarray(xprev0))
    tp = jax.tree.map(lambda a: torch.from_numpy(a.copy()), params)
    y, (s, last) = ssm.rwkv_scan(tp, cfg, torch.from_numpy(x),
                                 xprev0=torch.from_numpy(xprev0))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_array_equal(last.numpy(), np.asarray(last_ref))
