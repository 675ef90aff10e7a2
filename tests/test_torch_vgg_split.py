"""The port's VGG-5, split step and optimizers against the JAX package,
from the same weights (the reference's init, carried across).

Tolerances: the parameter carry is exact (transposes only). Logits
atol=1e-5 (float32 convolutions summed in another order). The split
step: loss rtol=1e-6, grads rtol=1e-4/atol=1e-6 (float32 backward
passes through three convolutions). The port's split step equals its
own monolithic grad to rtol=1e-5/atol=1e-7 (the same ops; only the
autograd graph is cut)."""
from __future__ import annotations

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import split as ref_split
from repro.models.vgg import VGG5 as RefVGG5
from repro.optim import optimizers as ref_optim
from repro_torch.core import split
from repro_torch.models.vgg import (VGG5, params_from_reference,
                                    params_to_reference)
from repro_torch.optim import optimizers
from repro_torch.tree import to_numpy


@pytest.fixture(scope="module")
def ref_params():
    return jax.tree.map(np.asarray, RefVGG5().init(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def batch_np():
    rng = np.random.default_rng(0)
    return {"images": rng.standard_normal((6, 32, 32, 3)).astype(np.float32),
            "labels": rng.integers(0, 10, 6).astype(np.int32)}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_param_carry_round_trips_exactly(ref_params):
    port = params_from_reference(ref_params, "cpu")
    assert port[0]["w"].shape == (32, 3, 3, 3)        # OIHW
    assert port[3]["w"].shape == (128, 1024)          # Linear (out, in)
    back = to_numpy(params_to_reference(port))
    for p, q in zip(back, ref_params):
        for k in ("w", "b"):
            np.testing.assert_array_equal(p[k], q[k])
    again = params_from_reference(back, "cpu")
    for p, q in zip(again, port):
        for k in ("w", "b"):
            assert torch.equal(p[k], q[k])


def test_logits_match_reference(ref_params, batch_np):
    want = np.asarray(RefVGG5().forward(ref_params, batch_np["images"]))
    model = VGG5(device="cpu")
    got = model.forward(torch.from_numpy(batch_np["images"]),
                        params_from_reference(ref_params, "cpu"))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5,
                               rtol=0)
    # the module's own parameters are the default tree
    model.load_params(params_from_reference(ref_params, "cpu"))
    np.testing.assert_array_equal(
        model(torch.from_numpy(batch_np["images"])).detach().numpy(),
        got.detach().numpy())
    assert len(model.stage(0, 2)) == 2 and len(model.stage(2, 5)) == 3


@pytest.mark.parametrize("sp", [1, 2, 3])
def test_split_value_and_grad_matches_reference(ref_params, batch_np, sp):
    rm = RefVGG5()
    rd, rs = ref_split.partition_params(rm, ref_params, sp)
    rbatch = {k: jnp.asarray(v) for k, v in batch_np.items()}
    r_loss, r_gd, r_gs = ref_split.split_value_and_grad(rm, rd, rs, rbatch,
                                                         sp)
    model = VGG5(device="cpu")
    d, s = split.partition_params(
        model, params_from_reference(ref_params, "cpu"), sp)
    loss, g_dev, g_srv = split.split_value_and_grad(model, d, s,
                                                    _tb(batch_np), sp)
    np.testing.assert_allclose(float(loss), float(r_loss), rtol=1e-6)
    got = to_numpy(params_to_reference(split.merge_grads(model, g_dev,
                                                         g_srv)))
    want = jax.tree.map(np.asarray, ref_split.merge_grads(rm, r_gd, r_gs))
    for g, w in zip(got, want):
        for k in ("w", "b"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("sp", [1, 2, 3, 4])
def test_split_step_equals_monolithic(ref_params, batch_np, sp):
    model = VGG5(device="cpu")
    params = params_from_reference(ref_params, "cpu")
    d, s = split.partition_params(model, params, sp)
    loss, g_dev, g_srv = split.split_value_and_grad(model, d, s,
                                                    _tb(batch_np), sp)
    m_loss, m_grads = split.monolithic_value_and_grad(model, params,
                                                      _tb(batch_np))
    assert float(loss) == pytest.approx(float(m_loss), rel=1e-6)
    for g, m in zip(split.merge_grads(model, g_dev, g_srv), m_grads):
        for k in ("w", "b"):
            torch.testing.assert_close(g[k], m[k], rtol=1e-5, atol=1e-7)
    smashed = split.device_forward(model, d, _tb(batch_np), sp)["h"]
    assert smashed.shape[0] == 6


@pytest.mark.parametrize("name", ["sgd", "adamw"])
def test_optimizer_update_matches_reference(ref_params, name):
    rng = np.random.default_rng(3)
    grads = jax.tree.map(
        lambda p: rng.standard_normal(p.shape).astype(np.float32),
        ref_params)
    ref_opt = getattr(ref_optim, name)()
    port_opt = getattr(optimizers, name)()
    r_state = ref_opt.init(ref_params)
    p_params = params_from_reference(ref_params, "cpu")
    p_grads = params_from_reference(grads, "cpu")
    p_state = port_opt.init(p_params)
    r_p, p_p = ref_params, p_params
    for _ in range(3):
        r_p, r_state = ref_opt.update(grads, r_state, r_p, jnp.float32(0.01))
        p_p, p_state = port_opt.update(p_grads, p_state, p_p, 0.01)
    assert int(p_state["step"]) == int(r_state["step"]) == 3
    assert p_state["step"].dtype == torch.int32
    got = to_numpy(params_to_reference(p_p))
    for g, w in zip(got, jax.tree.map(np.asarray, r_p)):
        for k in ("w", "b"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-6, atol=1e-7)
    mom = "mu" if name == "sgd" else "m"
    got_m = to_numpy(params_to_reference(p_state[mom]))
    for g, w in zip(got_m, jax.tree.map(np.asarray, r_state[mom])):
        for k in ("w", "b"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-6, atol=1e-7)


def test_optimizer_pickles_by_conf():
    opt = optimizers.sgd(momentum=0.8)
    back = pickle.loads(pickle.dumps(opt))
    assert back.conf == opt.conf and back.name == "sgd"
    with pytest.raises(TypeError):
        pickle.dumps(optimizers.Optimizer("x", lambda p: p, lambda *a: a))
