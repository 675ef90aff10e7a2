"""The port's ``TransformerLM`` against ``repro.models.transformer`` at the
reduced sizes of ``make_reduced``, with the reference's own parameters
carried over by ``params_from_reference``.

Checked: the parameter carry round-trips exactly; prefill last-token
logits and every collected cache entry match ``make_prefill_step``; three
teacher-forced ``decode_step``s (the same tokens fed to both packages)
match on logits and on every cache entry. A sliding-window variant of
qwen3 makes the ring buffer wrap.

Tolerance: atol = rtol = 1e-4 (float32 throughout; two layers of matmuls
summed in another order than XLA's).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import steps as jax_steps
from repro.models import registry as jax_registry
from repro_torch.launch import steps
from repro_torch.models import registry
from repro_torch.models.transformer import (TransformerLM,
                                            params_from_reference,
                                            params_to_reference)

TOL = dict(atol=1e-4, rtol=1e-4)
CPU = torch.device("cpu")
ARCHS = {"qwen3-0.6b": {}, "rwkv6-1.6b": {},
         "qwen3-0.6b-window": {"sliding_window": 4}}


def _pair(arch):
    name = arch.removesuffix("-window")
    extra = ARCHS[arch]
    ref_cfg = jax_registry.make_reduced(
        jax_registry.get_config(name)).replace(**extra)
    cfg = registry.make_reduced(registry.get_config(name)).replace(**extra)
    ref_model = jax_registry.build_model(ref_cfg)
    ref_params = jax.tree.map(np.asarray, ref_model.init(
        jax.random.PRNGKey(0)))
    model = registry.build_model(cfg, device=CPU)
    model.load_params(params_from_reference(ref_params, CPU))
    return ref_cfg, ref_model, ref_params, cfg, model


@pytest.fixture(scope="module")
def pairs():
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = _pair(arch)
        return cache[arch]
    return get


def _close(got, want):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **TOL)


def test_configs_are_copies_of_the_reference():
    for name in jax_registry.ARCH_IDS:
        assert (registry.get_config(name).__dict__
                == jax_registry.get_config(name).__dict__)
        assert (registry.make_reduced(registry.get_config(name)).__dict__
                == jax_registry.make_reduced(
                    jax_registry.get_config(name)).__dict__)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_params_round_trip_exactly(pairs, arch):
    _, _, ref_params, _, model = pairs(arch)
    back = params_to_reference(model.param_tree())
    ref_leaves, ref_def = jax.tree.flatten(ref_params)
    leaves, tdef = jax.tree.flatten(back)
    assert tdef == ref_def
    for a, b in zip(leaves, ref_leaves):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_prefill_matches_reference(pairs, arch):
    ref_cfg, ref_model, ref_params, cfg, model = pairs(arch)
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32)
    want_logits, want_aux = jax.jit(jax_steps.make_prefill_step(ref_model))(
        ref_params, {"tokens": jnp.asarray(tokens)})
    logits, aux = steps.make_prefill_step(model)(
        {"tokens": torch.from_numpy(tokens)})
    assert logits.shape == (2, 1, cfg.vocab_size)
    _close(logits, want_logits)
    assert sorted(aux) == sorted(want_aux)
    for key in aux:
        assert tuple(aux[key].shape) == want_aux[key].shape, key
        _close(aux[key], want_aux[key])


@pytest.mark.parametrize("arch", list(ARCHS))
def test_teacher_forced_decode_matches_reference(pairs, arch):
    ref_cfg, ref_model, ref_params, cfg, model = pairs(arch)
    B, steps_n = 2, 3 if not ARCHS[arch] else 6   # window 4: the ring wraps
    ref_cache = ref_model.init_cache(B, 8)
    cache = model.init_cache(B, 8)
    assert sorted(cache) == sorted(ref_cache)
    for key in cache:
        assert tuple(cache[key].shape) == ref_cache[key].shape
        assert str(cache[key].dtype).removeprefix("torch.") == \
            str(ref_cache[key].dtype)
    serve = jax.jit(jax_steps.make_serve_step(ref_model))
    port_serve = steps.make_serve_step(model)
    toks = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (steps_n, B, 1)).astype(np.int32)
    for pos in range(steps_n):
        want, ref_cache = serve(ref_params, ref_cache,
                                jnp.asarray(toks[pos]), jnp.int32(pos))
        got, cache = port_serve(cache, torch.from_numpy(toks[pos]), pos)
        assert got.shape == (B, 1, cfg.vocab_size)
        _close(got, want)
        for key in cache:
            _close(cache[key], ref_cache[key])


@pytest.mark.parametrize("arch", ["arctic-480b", "hymba-1.5b",
                                  "internvl2-1b", "whisper-large-v3",
                                  "gemma2-9b"])
def test_unported_archs_raise(arch):
    cfg = registry.get_config(arch)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TransformerLM(registry.make_reduced(cfg).replace(head_dim=256)
                      if arch == "gemma2-9b" else registry.make_reduced(cfg),
                      device=CPU)
