"""The port's FedAvg against ``repro.core.fedavg`` and the
``fedavg_agg`` oracle.

Tolerance: rtol=1e-6 (float32: a sum of E products, each rounded, in an
order that may differ from XLA's by a few ulp)."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.fedavg import fedavg as ref_fedavg
from repro.kernels.fedavg_agg import ops as ref_ops
from repro.kernels.fedavg_agg.ref import fedavg_agg_ref as ref_agg
from repro_torch.core.fedavg import fedavg, normalize_weights
from repro_torch.kernels.fedavg_agg import ops
from repro_torch.kernels.fedavg_agg.fedavg_agg import fedavg_agg
from repro_torch.kernels.fedavg_agg.ref import fedavg_agg_ref

RTOL, ATOL = 1e-6, 1e-7


def _vgg_like_trees(E, seed=0):
    rng = np.random.default_rng(seed)
    shapes = [((3, 3, 3, 32), (32,)), ((3, 3, 32, 64), (64,)),
              ((1024, 128), (128,)), ((128, 10), (10,))]
    return [[{"w": rng.standard_normal(w).astype(np.float32),
              "b": rng.standard_normal(b).astype(np.float32)}
             for w, b in shapes] for _ in range(E)]


@pytest.mark.parametrize("E,N", [(1, 7), (4, 188810), (3, 4097)])
def test_plain_agg_matches_reference(E, N):
    rng = np.random.default_rng(N)
    stacked = rng.standard_normal((E, N)).astype(np.float32)
    w = rng.uniform(0.5, 2.0, E).astype(np.float32)
    want = np.asarray(ref_agg(stacked, w))
    got = fedavg_agg(torch.from_numpy(stacked), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(
        fedavg_agg_ref(torch.from_numpy(stacked), w).numpy(), got.numpy())


@pytest.mark.parametrize("weights", [[40, 40, 40, 40], [1000, 1000, 1000, 1000],
                                     [10, 20, 30, 45]])
def test_fedavg_matches_reference(weights):
    trees = _vgg_like_trees(len(weights))
    want = ref_fedavg(trees, weights)
    port_trees = [[{k: torch.from_numpy(v) for k, v in p.items()} for p in t]
                  for t in trees]
    got = fedavg(port_trees, weights)
    for g, w in zip(got, want):
        for k in ("w", "b"):
            assert g[k].shape == w[k].shape
            np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]),
                                       rtol=RTOL, atol=ATOL)


def test_normalize_weights_matches_reference():
    from repro.core.fedavg import normalize_weights as ref_norm
    for w in ([1, 2, 3], [0, 0], [1e-20, 1e-20]):
        np.testing.assert_array_equal(normalize_weights(w).numpy(),
                                      np.asarray(ref_norm(w)))


def test_fedavg_tree_matches_reference():
    trees = _vgg_like_trees(3, seed=5)
    stacked = [{k: np.stack([t[i][k] for t in trees]) for k in ("w", "b")}
               for i in range(4)]
    w = np.array([3.0, 1.0, 2.0], np.float32)
    want = ref_ops.fedavg_tree(stacked, w, use_pallas=False)
    got = ops.fedavg_tree([{k: torch.from_numpy(v) for k, v in p.items()}
                           for p in stacked], w)
    for g, r in zip(got, want):
        for k in ("w", "b"):
            np.testing.assert_allclose(g[k].numpy(), np.asarray(r[k]),
                                       rtol=RTOL, atol=ATOL)


def test_stacked_helpers_match_reference():
    """fedavg_stacked (rtol 1e-6: float32 sums in XLA's order and in
    torch's), broadcast_stacked and tree_weighted_delta (exact)."""
    from repro.core.fedavg import broadcast_stacked as ref_broadcast
    from repro.core.fedavg import fedavg_stacked as ref_stacked
    from repro.core.fedavg import tree_weighted_delta as ref_delta
    from repro_torch.core.fedavg import (broadcast_stacked, fedavg_stacked,
                                         tree_weighted_delta)
    trees = _vgg_like_trees(3, seed=7)
    stacked = [{k: np.stack([t[i][k] for t in trees]) for k in ("w", "b")}
               for i in range(4)]
    port = [{k: torch.from_numpy(v) for k, v in p.items()} for p in stacked]
    w = np.array([3.0, 1.0, 2.0], np.float32)
    for g, r in zip(fedavg_stacked(port, w), ref_stacked(stacked,
                                                          jnp.asarray(w))):
        for k in ("w", "b"):
            np.testing.assert_allclose(g[k].numpy(), np.asarray(r[k]),
                                       rtol=RTOL, atol=ATOL)
    one = [{k: torch.from_numpy(v) for k, v in p.items()} for p in trees[0]]
    for g, r in zip(broadcast_stacked(one, 4), ref_broadcast(trees[0], 4)):
        for k in ("w", "b"):
            assert g[k].shape == r[k].shape
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(r[k]))
    other = [{k: torch.from_numpy(v) for k, v in p.items()} for p in trees[1]]
    for g, r in zip(tree_weighted_delta(one, other),
                    ref_delta(trees[0], trees[1])):
        for k in ("w", "b"):
            assert g[k].dtype == torch.float32
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(r[k]))
