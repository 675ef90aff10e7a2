"""The port's serving launcher and decode-session migration against the JAX
package (``repro.launch.serve``, ``repro.core.serve_migration``) at
reduced size.

Checked: ``build_cache_from_prefill`` plus 8 teacher-forced decode steps
(the reference's greedy tokens fed to both) match the reference at
atol = rtol = 1e-4; a ``ServeSession``'s raw container, and the
migration checkpoint that carries it, are byte-identical to the
reference's for the same cache; a raw-codec migration through the port's
``MigrationExecutor`` resumes with decode logits bit-identical to not
moving, and leaves a session's tree as it is (no VGG layout conversion,
scalars back as Python values); the int8 payload is under raw / 2; the
CLI runs on the CPU.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.checkpoint import EdgeCheckpoint as RefCheckpoint
from repro.core.serve_migration import ServeSession as RefSession
from repro.launch import serve as jax_serve
from repro.launch import steps as jax_steps
from repro.models import registry as jax_registry
from repro_torch.core.checkpoint import EdgeCheckpoint
from repro_torch.core.migration import MigrationExecutor
from repro_torch.core.serve_migration import ServeSession, migrate_session
from repro_torch.data.datasets import synthetic_tokens
from repro_torch.launch import serve
from repro_torch.models import registry
from repro_torch.models.transformer import params_from_reference

CPU = torch.device("cpu")
TOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = ["qwen3-0.6b", "rwkv6-1.6b"]
B, PROMPT, GEN = 2, 12, 8


@pytest.fixture(scope="module")
def served():
    """Per arch: both models, and the reference's prefill + 8 greedy
    decode steps with the port teacher-forced on the same tokens."""
    out = {}

    def get(arch):
        if arch in out:
            return out[arch]
        ref_cfg = jax_registry.make_reduced(jax_registry.get_config(arch))
        cfg = registry.make_reduced(registry.get_config(arch))
        ref_model = jax_registry.build_model(ref_cfg)
        ref_params = jax.tree.map(np.asarray,
                                  ref_model.init(jax.random.PRNGKey(0)))
        model = registry.build_model(cfg, device=CPU)
        model.load_params(params_from_reference(ref_params, CPU))
        tokens = synthetic_tokens(B, PROMPT, cfg.vocab_size, 3)["tokens"]

        ref_logits, ref_cache = jax_serve.build_cache_from_prefill(
            ref_model, ref_cfg, ref_params, {"tokens": jnp.asarray(tokens)},
            PROMPT, PROMPT + GEN)
        logits, cache = serve.build_cache_from_prefill(
            model, cfg, {"tokens": torch.from_numpy(tokens)}, PROMPT,
            PROMPT + GEN)
        steps = [(logits, ref_logits, {k: v.clone() for k, v in
                                       cache.items()}, ref_cache)]
        ref_step = jax.jit(jax_steps.make_serve_step(ref_model))
        for i in range(GEN):
            tok = jnp.argmax(ref_logits[:, -1], -1)[:, None].astype(
                jnp.int32)
            ref_logits, ref_cache = ref_step(ref_params, ref_cache, tok,
                                             jnp.int32(PROMPT + i))
            logits, cache = model.decode_step(
                cache, torch.from_numpy(np.array(tok)), PROMPT + i)
            steps.append((logits, ref_logits,
                          {k: v.clone() for k, v in cache.items()},
                          ref_cache))
        out[arch] = (cfg, model, steps)
        return out[arch]
    return get


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(served, arch):
    _, _, steps = served(arch)
    assert len(steps) == GEN + 1
    for logits, ref_logits, cache, ref_cache in steps:
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                                   **TOL)
        assert sorted(cache) == sorted(ref_cache)
        for key in cache:
            np.testing.assert_allclose(cache[key].float().numpy(),
                                       np.asarray(ref_cache[key], np.float32),
                                       **TOL)


def _ref_cache_as_port(ref_cache):
    return {k: torch.from_numpy(np.array(v)) for k, v in ref_cache.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_session_containers_are_byte_identical(served, arch):
    _, _, steps = served(arch)
    ref_cache = steps[4][3]
    ref_sess = RefSession("dev0-session", ref_cache, position=PROMPT + 4,
                          tokens_generated=4)
    sess = ServeSession("dev0-session", _ref_cache_as_port(ref_cache),
                        position=PROMPT + 4, tokens_generated=4)
    assert sess.pack("raw", device=CPU) == ref_sess.pack("raw")
    assert sess.pack("int8", device=CPU) == ref_sess.pack("int8")
    # the migration checkpoint carrying the session, too
    ref_ck = RefCheckpoint(
        client_id="dev0-session", round_idx=0, epoch=0,
        batch_idx=PROMPT + 4, split_point=0,
        server_params=ref_sess.to_tree(), optimizer_state={},
        meta={"kind": "serve_session"})
    ck = EdgeCheckpoint(
        client_id="dev0-session", round_idx=0, epoch=0,
        batch_idx=PROMPT + 4, split_point=0, server_params=sess.to_tree(),
        optimizer_state={}, meta={"kind": "serve_session"})
    assert ck.pack("raw", device=CPU) == ref_ck.pack("raw")
    # and each package unpacks the other's
    back = ServeSession.unpack(ref_sess.pack("raw"), device=CPU)
    assert (back.session_id, back.position, back.tokens_generated) == \
        ("dev0-session", PROMPT + 4, 4)
    for key, val in back.cache.items():
        np.testing.assert_array_equal(val.numpy(), np.asarray(ref_cache[key]))


@pytest.mark.parametrize("arch", ARCHS)
def test_migrated_session_resumes_bit_identically(served, arch):
    cfg, model, steps = served(arch)
    _, _, cache, _ = steps[4]
    pos = PROMPT + 4
    sess = ServeSession("dev0-session", {k: v.clone() for k, v in
                                         cache.items()}, position=pos)
    ex = MigrationExecutor(device=CPU)
    restored, rep = migrate_session(sess, ex, "edge-A", "edge-B")
    # the session's container plus the checkpoint's own scalars
    assert rep.nbytes > sess.nbytes("raw", device=CPU)
    assert isinstance(restored.position, int) and restored.position == pos
    assert restored.session_id == "dev0-session"
    tok = torch.full((B, 1), 7, dtype=torch.int32)
    l_direct, _ = model.decode_step(cache, tok, pos)
    l_moved, _ = model.decode_step(restored.cache, tok, pos)
    assert torch.equal(l_direct, l_moved)

    # the packed-int8 (delta, no base) codec: approximate, but finite
    d_sess, d_rep = migrate_session(
        sess, MigrationExecutor(codec="delta", device=CPU), "edge-A",
        "edge-B")
    assert d_rep.nbytes < rep.nbytes / 2
    assert 0 < d_rep.quant_error < 1.0
    l_delta, _ = model.decode_step(d_sess.cache, tok, pos)
    assert bool(torch.isfinite(l_delta).all())


def test_session_tree_crosses_unconverted():
    """A 2-D leaf in a session would be transposed by VGG-5's layout
    conversion; a serve session must cross exactly as it is."""
    rng = np.random.default_rng(0)
    cache = {"a2d": torch.from_numpy(rng.standard_normal((3, 5)).astype(
                 np.float32)),
             "b4d": torch.from_numpy(rng.standard_normal((2, 3, 4, 5))
                                     .astype(np.float32))}
    sess = ServeSession("s", cache, position=9, tokens_generated=2)
    restored, _ = migrate_session(sess, MigrationExecutor(device=CPU),
                                  "edge-A", "edge-B")
    assert (restored.position, restored.tokens_generated) == (9, 2)
    for key, val in cache.items():
        assert torch.equal(restored.cache[key], val)


def test_session_int8_payload_smaller():
    cfg = registry.make_reduced(registry.get_config("qwen3-0.6b"))
    model = registry.build_model(cfg, device=CPU)
    cache = {k: v + 0.1 if v.is_floating_point() else v
             for k, v in model.init_cache(2, 64).items()}
    sess = ServeSession("s", cache, position=0)
    assert sess.nbytes("int8", device=CPU) < sess.nbytes("raw",
                                                         device=CPU) / 2


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_runs_on_cpu(arch, caplog):
    caplog.set_level("INFO", logger="repro_torch.launch.serve")
    serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--batch",
                "2", "--prompt-len", "8", "--gen", "4"])
    assert any("decode:" in r.message for r in caplog.records)
    assert caplog.records[-1].message == "ok"
