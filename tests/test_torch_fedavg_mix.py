"""The port's FedAsync batched mix (``fedavg_agg_mix``'s plain version and
``fedavg_mix_tree``) against the reference's ``fedavg_agg_mix_ref`` and
``fedavg_mix_tree(use_pallas=False)``, on the same numpy inputs.

Tolerances: float32 outputs rtol=1e-6, atol=1e-7 (the E products are
summed in row order here and by XLA's or BLAS's dot in the reference: a
few float32 ulp apart). bf16 outputs rtol=2**-8, atol=1e-7: one bf16 ulp,
since float32 sums a few ulp apart may round to neighbouring bf16 values.
The port's own plain version and tree layer agree bit for bit. The
sequential-mixing identity holds to atol=1e-5, the reference test's
bound."""
from __future__ import annotations

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.fedavg_agg import ops as ref_ops
from repro.kernels.fedavg_agg.ref import fedavg_agg_mix_ref as ref_mix
from repro_torch.kernels.fedavg_agg.fedavg_agg import fedavg_agg_mix
from repro_torch.kernels.fedavg_agg.ops import fedavg_mix_tree
from repro_torch.kernels.fedavg_agg.ref import fedavg_agg_mix_ref, mix_coeffs

RTOL, ATOL = 1e-6, 1e-7
BF16_RTOL = 2.0 ** -8


def _t(a: np.ndarray) -> torch.Tensor:
    """numpy (float32 or ml_dtypes bfloat16) -> torch, same values."""
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


# the reference's own sweep (tests/test_kernels.py::test_fedavg_agg_mix_sweep)
@pytest.mark.parametrize("E,n,dt", [(1, 4096, "float32"),
                                    (4, 10000, "float32"),
                                    (8, 4096, "bfloat16"),
                                    (13, 12288, "float32")])
def test_plain_mix_matches_reference(E, n, dt):
    rng = np.random.default_rng(E * 1000 + n)
    np_dt = ml_dtypes.bfloat16 if dt == "bfloat16" else np.float32
    g = rng.standard_normal(n).astype(np_dt)
    x = rng.standard_normal((E, n)).astype(np_dt)
    w = rng.uniform(0.0, 0.5 / E, E).astype(np.float32)
    got = fedavg_agg_mix(_t(g), _t(x).float(), w)
    assert got.dtype == (torch.bfloat16 if dt == "bfloat16"
                         else torch.float32)
    rtol = BF16_RTOL if dt == "bfloat16" else RTOL
    want = np.asarray(ref_mix(jnp.asarray(g), jnp.asarray(x),
                              jnp.asarray(w)), np.float32)
    np.testing.assert_allclose(_np(got), want, rtol=rtol, atol=ATOL)
    if dt == "float32":     # the reference tree passes bf16 leaves through
        tree = np.asarray(ref_ops.fedavg_mix_tree(
            {"w": g}, [{"w": x[e]} for e in range(E)], list(w),
            use_pallas=False)["w"], np.float32)
        np.testing.assert_allclose(_np(got), tree, rtol=rtol, atol=ATOL)
    # the plain version is the dispatch's CPU path, bit for bit
    same = fedavg_agg_mix_ref(_t(g), _t(x).float(), w)
    assert torch.equal(got, same)


def test_keep_is_the_reference_numpy_keep():
    """``keep`` is summed by numpy in float32, as the reference's numpy
    path sums it: bit-equal for any count (numpy's pairwise sum above 8)."""
    rng = np.random.default_rng(3)
    for E in (1, 7, 9, 32, 200):
        c = rng.uniform(0.0, 1.0 / E, E)
        w, keep = mix_coeffs(list(c))
        ref_w = np.asarray(c, np.float32)
        assert keep == np.float32(1.0) - ref_w.sum(dtype=np.float32)
        np.testing.assert_array_equal(w, ref_w)


def test_mix_equals_sequential_mixing():
    """b_i = a_i * prod_{j>i}(1-a_j) makes one mix equal a chain of
    (1-a) g + a u mixes — the AsyncAggregator batching identity."""
    rng = np.random.default_rng(0)
    g = rng.normal(size=5000).astype(np.float32)
    x = rng.normal(size=(4, 5000)).astype(np.float32)
    alphas = [0.3, 0.12, 0.5, 0.08]
    seq = g.copy()
    for i, a in enumerate(alphas):
        seq = (1 - a) * seq + a * x[i]
    eff = [a * np.prod([1.0 - b for b in alphas[i + 1:]])
           for i, a in enumerate(alphas)]
    out = fedavg_agg_mix(_t(g), _t(x), eff)
    np.testing.assert_allclose(out.numpy(), seq, atol=1e-5)


def _tree(rng, dtype_b=np.float32):
    return {"conv": {"w": rng.standard_normal((3, 3, 3, 8)).astype(
                np.float32), "b": rng.standard_normal(8).astype(dtype_b)},
            "fc": [rng.standard_normal((40, 10)).astype(np.float32),
                   rng.standard_normal(10).astype(np.float32)],
            "step": np.array(7, np.int32)}


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_torch_tree(v) for v in tree]
    return _t(tree)


@pytest.mark.parametrize("E", [1, 5])
def test_mix_tree_matches_reference_tree(E):
    """A tree with a bf16 leaf and an int leaf: float leaves mixed in one
    buffer and returned in their own dtype, the int leaf passed through.
    The reference's tree layer tests floatness with ``np.issubdtype(...,
    np.floating)``, which is False for ml_dtypes' bfloat16, so it passes
    a bf16 leaf through unmixed; the port mixes it, and the leaf is held
    against the flat oracle ``fedavg_agg_mix_ref`` instead."""
    rng = np.random.default_rng(E)
    g = _tree(rng, dtype_b=ml_dtypes.bfloat16)
    ups = [_tree(rng) for _ in range(E)]
    for u in ups:
        u["step"] = np.array(9, np.int32)
    c = list(rng.uniform(0.0, 0.3 / E, E))
    want = ref_ops.fedavg_mix_tree(g, ups, c, use_pallas=False)
    tg = _torch_tree(g)
    got = fedavg_mix_tree(tg, [_torch_tree(u) for u in ups], c)
    assert got["step"] is tg["step"] and int(got["step"]) == 7
    assert got["conv"]["b"].dtype == torch.bfloat16
    assert got["conv"]["w"].dtype == torch.float32
    want_b = ref_mix(jnp.asarray(g["conv"]["b"]),
                     jnp.asarray(np.stack([u["conv"]["b"] for u in ups])),
                     jnp.asarray(c, jnp.float32))
    for gl, wl, rtol in ((got["conv"]["w"], want["conv"]["w"], RTOL),
                         (got["conv"]["b"], want_b, BF16_RTOL),
                         (got["fc"][0], want["fc"][0], RTOL),
                         (got["fc"][1], want["fc"][1], RTOL)):
        assert tuple(gl.shape) == np.shape(wl)
        np.testing.assert_allclose(_np(gl), np.asarray(wl, np.float32),
                                   rtol=rtol, atol=ATOL)


def test_mix_tree_non_float_leaves_pass_through():
    g = {"w": torch.ones((64, 64)), "step": torch.tensor(7)}
    ups = [{"w": torch.zeros((64, 64)), "step": torch.tensor(9)}]
    out = fedavg_mix_tree(g, ups, [0.25])
    assert out["step"] is g["step"]
    np.testing.assert_allclose(out["w"].numpy(), 0.75, atol=1e-6)


def test_mix_tree_empty_update_list_returns_global():
    g = {"w": torch.ones(3)}
    assert fedavg_mix_tree(g, [], []) is g


def test_mix_kernel_refuses_cpu_tensors_when_asked():
    with pytest.raises(ValueError):
        fedavg_agg_mix(torch.zeros(3), torch.zeros(2, 3), [0.1, 0.2],
                       use_kernel=True)
