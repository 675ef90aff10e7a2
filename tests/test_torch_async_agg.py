"""The port's exact coefficient fold, Sync/Async aggregators and
floating-root placement against the reference (``repro.kernels.fedavg_agg``
coeff_*, ``repro.sim.async_agg``, ``repro.sim.agg_tree``), on the same
numpy inputs. Mirrors ``tests/test_agg_tree.py``'s algebra, coefficient,
empty-window and placement cases.

Tolerances: none — every comparison here is bit-exact (int64 fold,
float64 coefficients, float32 results of one final rounding, and the
sequential float32 ``submit``, which is the same elementwise arithmetic
in both packages). The one float comparison is the kernel form of a
flush window, ``fedavg_mix_tree(flush_coeffs)``, against the exact
``flush_batch``: float32 with E + 2 roundings per element, so it is held
to (E + 2) * 2**-23 * (|keep| max|g| + sum|c| max|u|)."""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro.kernels.fedavg_agg import (coeff_finalize_tree as r_finalize,
                                      coeff_fold_tree as r_fold,
                                      coeff_merge_trees as r_merge,
                                      coeff_term_tree as r_term)
from repro.kernels.fedavg_agg.ref import coeff_finalize_ref as r_fin_ref
from repro.kernels.fedavg_agg.ref import coeff_fold_ref as r_fold_ref
from repro.runtime.transport import LinkModel as RefLink
from repro.sim import agg_tree as r_tree
from repro.sim import async_agg as r_agg
from repro_torch.kernels.fedavg_agg.ops import (coeff_finalize_tree,
                                                coeff_fold_tree,
                                                coeff_merge_trees,
                                                coeff_term_tree,
                                                fedavg_mix_tree)
from repro_torch.kernels.fedavg_agg.ref import (coeff_finalize_ref,
                                                coeff_fold_ref)
from repro_torch.runtime.transport import LinkModel
from repro_torch.sim import agg_tree, async_agg
from repro_torch.tree import tree_leaves


def _rand_trees(rng, n, shape=(5, 3)):
    return [{"w": rng.standard_normal(shape).astype(np.float32) * 4.0,
             "b": rng.standard_normal(shape[0]).astype(np.float32),
             "step": np.int64(7)} for _ in range(n)]


def _port(tree):
    """numpy tree -> torch tree of copies (float32, int64 scalars)."""
    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in
            tree.items()}


def _assert_same(port_tree, ref_tree):
    """Leafwise bit-equality (and dtype equality) of a port tree and a
    reference tree."""
    got, want = tree_leaves(port_tree), jax.tree.leaves(ref_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# exact-fold algebra
# ---------------------------------------------------------------------------

def test_coeff_fold_tree_matches_reference_and_flat_ref():
    rng = np.random.default_rng(0)
    trees = _rand_trees(rng, 6)
    coeffs = list(rng.uniform(0.0, 0.4, size=6))
    acc = coeff_fold_tree([_port(t) for t in trees], coeffs)
    _assert_same(acc, r_fold(trees, coeffs))
    stacked = np.stack([t["w"].ravel() for t in trees])
    want = r_fold_ref(stacked, np.array(coeffs))
    np.testing.assert_array_equal(acc["w"].numpy().ravel(), want)
    np.testing.assert_array_equal(coeff_fold_ref(stacked, np.array(coeffs)),
                                  want)
    assert acc["step"].shape == () and int(acc["step"]) == 0
    assert coeff_fold_tree([], []) is None


@pytest.mark.parametrize("coeff", [0.0, 1e-9, 0.3, 1.0])
def test_coeff_term_tree_matches_reference(coeff):
    rng = np.random.default_rng(11)
    t = _rand_trees(rng, 1)[0]
    t["w"][0, :3] = [0.0, -0.0, 2.0 ** -41]     # exact halves round to even
    _assert_same(coeff_term_tree(_port(t), coeff), r_term(t, coeff))


def test_partition_invariance_any_split_any_order():
    """int64 partials over ANY partition of the window, merged in ANY
    order, equal the flat fold bit-for-bit — and the reference's."""
    rng = np.random.default_rng(1)
    trees = _rand_trees(rng, 8)
    ports = [_port(t) for t in trees]
    coeffs = list(rng.uniform(0.0, 0.2, size=8))
    flat = coeff_fold_tree(ports, coeffs)
    _assert_same(flat, r_fold(trees, coeffs))
    for seed in range(5):
        r = np.random.default_rng(seed)
        cut1, cut2 = sorted(r.integers(0, 9, size=2))
        parts = [list(range(0, cut1)), list(range(cut1, cut2)),
                 list(range(cut2, 8))]
        accs = [coeff_fold_tree([ports[i] for i in p],
                                [coeffs[i] for i in p]) if p else None
                for p in parts]
        r.shuffle(accs)
        _assert_same(coeff_merge_trees(accs), r_fold(trees, coeffs))
    assert coeff_merge_trees([None, None]) is None


@pytest.mark.parametrize("keep", [0.0, 0.125, 0.7310585786300049])
def test_finalize_matches_reference_and_ref(keep):
    rng = np.random.default_rng(2)
    g = rng.standard_normal(40).astype(np.float32)
    trees = _rand_trees(rng, 3, shape=(8, 5))
    coeffs = [0.25, 0.5, 0.125]
    glob = {"w": g.reshape(8, 5), "b": g[:8], "step": np.int64(3)}
    r_acc = r_merge([r_term(t, c) for t, c in zip(trees, coeffs)])
    acc = coeff_merge_trees([coeff_term_tree(_port(t), c)
                             for t, c in zip(trees, coeffs)])
    out = coeff_finalize_tree(_port(glob), keep, acc)
    _assert_same(out, r_finalize(glob, keep, r_acc))
    want = r_fin_ref(g.reshape(8, 5).ravel(), keep, r_acc["w"].ravel())
    np.testing.assert_array_equal(out["w"].numpy().ravel(), want)
    np.testing.assert_array_equal(
        coeff_finalize_ref(g.reshape(8, 5).ravel(), keep,
                           r_acc["w"].ravel()), want)
    assert int(out["step"]) == 3
    g_port = _port(glob)
    assert coeff_finalize_tree(g_port, keep, None) is g_port


# ---------------------------------------------------------------------------
# coefficient contract
# ---------------------------------------------------------------------------

def test_sync_group_keep_coeffs_match_reference():
    rng = np.random.default_rng(6)
    for n in (0, 1, 3, 17):
        w = list(rng.uniform(0.0, 100.0, n))
        assert async_agg.sync_coeffs(w) == r_agg.sync_coeffs(w)
        assert async_agg.sync_coeffs([0.0] * n) == r_agg.sync_coeffs([0.0] * n)
        keys = [int(k) for k in rng.integers(0, 4, n)]
        cs = list(rng.uniform(0.0, 0.1, n))
        grouped = async_agg.group_coeffs(keys, cs)
        want = r_agg.group_coeffs(keys, cs)
        assert grouped == want and list(grouped) == list(want)
        assert async_agg.keep_coeff(grouped) == r_agg.keep_coeff(want)


@pytest.mark.parametrize("name,args", [("constant_staleness", ()),
                                       ("poly_staleness", (0.5,)),
                                       ("hinge_staleness", (4e-3, 2000.0))])
def test_staleness_functions_match_reference(name, args):
    fn, ref = getattr(async_agg, name)(*args), getattr(r_agg, name)(*args)
    for tau in (-3, 0, 1, 2, 7, 1999, 2000, 2001, 2500, 10 ** 6):
        assert fn(tau) == ref(tau)


# ---------------------------------------------------------------------------
# the aggregators over seeded sequences
# ---------------------------------------------------------------------------

def _window(rng, pool, n, max_stale=6):
    """n arrival-ordered (tree index, weight, staleness) drawn from a pool
    of trees, so some updates share a tree (cohort replicas)."""
    return [(int(rng.integers(0, pool)), float(rng.uniform(1.0, 20.0)),
             int(rng.integers(0, max_stale))) for _ in range(n)]


def test_sync_aggregator_rounds_match_reference():
    rng = np.random.default_rng(7)
    init = {"w": rng.standard_normal((6, 2)).astype(np.float32),
            "step": np.int64(0)}
    ref, port = r_agg.SyncAggregator(init), async_agg.SyncAggregator(
        _port(init))
    for n in (3, 0, 5, 1, 0, 4):                  # empty rounds included
        trees = _rand_trees(rng, n, shape=(6, 2))
        weights = list(rng.uniform(0.0, 50.0, n))
        for t, w in zip(trees, weights):
            ref.submit({"w": t["w"], "step": t["step"]}, w)
            port.submit(_port({"w": t["w"], "step": t["step"]}), w)
        _assert_same(port.commit(), ref.commit())
        assert (port.version, port.skipped_rounds) == (ref.version,
                                                       ref.skipped_rounds)
    assert port.skipped_rounds == 2
    # an empty two-level fold takes the same path
    port.commit_acc(None, 0)
    ref.commit_acc(None, 0)
    assert (port.version, port.skipped_rounds) == (ref.version,
                                                   ref.skipped_rounds)


@pytest.mark.parametrize("staleness", ["constant", "poly", "hinge"])
def test_async_aggregator_sequence_matches_reference(staleness):
    """Interleaved sequential submits and flush windows (one empty), in
    both packages: params bit-equal, and the version, EMA, skip counter,
    applied weight and returned alphas equal."""
    fns = {"constant": ("constant_staleness", ()),
           "poly": ("poly_staleness", (0.5,)),
           "hinge": ("hinge_staleness", (0.5, 2.0))}
    name, args = fns[staleness]
    rng = np.random.default_rng(8)
    init = {"w": rng.standard_normal((4, 4)).astype(np.float32),
            "b": rng.standard_normal(4).astype(np.float32),
            "step": np.int64(1)}
    ref = r_agg.AsyncAggregator(init, alpha=0.5,
                                staleness_fn=getattr(r_agg, name)(*args))
    port = async_agg.AsyncAggregator(
        _port(init), alpha=0.5, staleness_fn=getattr(async_agg, name)(*args))
    pool = _rand_trees(rng, 5, shape=(4, 4))
    ports = [_port(t) for t in pool]
    for step in range(6):
        if step % 2 == 0:
            i, w, s = _window(rng, 5, 1)[0]
            assert port.submit(ports[i], w, s) == ref.submit(pool[i], w, s)
        else:
            win = _window(rng, 5, 0 if step == 3 else 9)
            a_p = port.flush_batch([(ports[i], w, s) for i, w, s in win])
            a_r = ref.flush_batch([(pool[i], w, s) for i, w, s in win])
            assert a_p == a_r
        _assert_same(port.params, ref.params)
        assert (port.version, port.skipped_flushes, port._weight_ema,
                port.total_weight_applied) == (
            ref.version, ref.skipped_flushes, ref._weight_ema,
            ref.total_weight_applied)
    assert port.skipped_flushes == 1
    _assert_same(port.commit(), ref.commit())


def test_async_empty_flush_is_a_counted_noop():
    agg = async_agg.AsyncAggregator({"w": torch.ones(3)})
    assert agg.flush_batch([]) == []
    assert agg.commit_acc(None, 1.0, []) == []
    assert agg.version == 0 and agg.skipped_flushes == 2
    assert torch.equal(agg.commit()["w"], torch.ones(3))


def _partial_vs_flat_commit(weights, partition, shape=(6, 2), seed=3):
    rng = np.random.default_rng(seed)
    init = {"w": np.zeros(shape, np.float32)}
    trees = [{"w": rng.standard_normal(shape).astype(np.float32)}
             for _ in weights]
    flat_agg = async_agg.SyncAggregator(_port(init))
    ref_agg = r_agg.SyncAggregator(init)
    for t, w in zip(trees, weights):
        flat_agg.submit(_port(t), w)
        ref_agg.submit(t, w)
    flat_out = flat_agg.commit()
    coeffs = async_agg.sync_coeffs(list(weights))
    accs = [coeff_fold_tree([_port(trees[i]) for i in p],
                            [coeffs[i] for i in p])
            for p in partition if p]
    tree_agg = async_agg.SyncAggregator(_port(init))
    tree_out = tree_agg.commit_acc(coeff_merge_trees(accs), len(weights))
    return flat_out, tree_out, ref_agg.commit()


def test_sync_partial_then_root_equals_flat():
    rng = np.random.default_rng(4)
    for trial in range(10):
        n = int(rng.integers(1, 9))
        weights = rng.uniform(0.0, 50.0, size=n)
        cuts = sorted(rng.integers(0, n + 1, size=2))
        partition = [list(range(0, cuts[0])),
                     list(range(cuts[0], cuts[1])),
                     list(range(cuts[1], n))]
        flat_out, tree_out, ref_out = _partial_vs_flat_commit(
            weights, partition, seed=trial)
        _assert_same(flat_out, ref_out)
        _assert_same(tree_out, ref_out)


def test_async_partial_then_root_equals_flush_batch():
    rng = np.random.default_rng(5)
    init = {"w": rng.standard_normal((4, 4)).astype(np.float32)}
    window = [({"w": rng.standard_normal((4, 4)).astype(np.float32)},
               float(rng.uniform(1.0, 20.0)), int(rng.integers(0, 5)))
              for _ in range(6)]
    ref = r_agg.AsyncAggregator(init, alpha=0.5)
    ref.flush_batch(window)
    p_window = [(_port(t), w, s) for t, w, s in window]
    for cut in range(7):
        a_flat = async_agg.AsyncAggregator(_port(init), alpha=0.5)
        a_flat.flush_batch(p_window)
        a_tree = async_agg.AsyncAggregator(_port(init), alpha=0.5)
        keyed = [((i,), w, s) for i, (_, w, s) in enumerate(p_window)]
        alphas, grouped, keep = a_tree.flush_coeffs(keyed)
        keys = list(grouped)
        accs = [coeff_fold_tree([p_window[k[0]][0] for k in part],
                                [grouped[k] for k in part])
                for part in (keys[:cut], keys[cut:]) if part]
        a_tree.commit_acc(coeff_merge_trees(accs), keep, alphas)
        _assert_same(a_flat.params, ref.params)
        _assert_same(a_tree.params, ref.params)
        assert a_flat.version == a_tree.version == ref.version


def test_kernel_mix_of_flush_coeffs_within_bound_of_flush_batch():
    """The float form of a window (one fedavg_mix_tree over the grouped
    flush coefficients) against the exact int64 form, within the float32
    bound of E + 2 roundings."""
    rng = np.random.default_rng(9)
    init = {"w": rng.standard_normal((32, 16)).astype(np.float32),
            "b": rng.standard_normal(16).astype(np.float32)}
    pool = [_port({"w": rng.standard_normal((32, 16)).astype(np.float32),
                   "b": rng.standard_normal(16).astype(np.float32)})
            for _ in range(6)]
    win = [(pool[i], w, s) for i, w, s in _window(rng, 6, 40, 3000)]
    fn = async_agg.hinge_staleness(a=4e-3, b=2000.0)
    exact = async_agg.AsyncAggregator(_port(init), alpha=0.6,
                                      staleness_fn=fn)
    mixer = async_agg.AsyncAggregator(_port(init), alpha=0.6,
                                      staleness_fn=fn)
    exact.flush_batch(win)
    _, grouped, keep = mixer.flush_coeffs([(id(t), w, s) for t, w, s in win])
    trees = {id(t): t for t, _, _ in win}
    mixed = fedavg_mix_tree(mixer.params, [trees[k] for k in grouped],
                            list(grouped.values()))
    E = len(grouped)
    max_g = max(float(x.abs().max()) for x in tree_leaves(mixer.params))
    max_u = max(float(x.abs().max()) for t in pool for x in tree_leaves(t))
    bound = (E + 2) * 2.0 ** -23 * (abs(keep) * max_g + sum(
        abs(c) for c in grouped.values()) * max_u)
    err = max(float((a - b).abs().max()) for a, b in
              zip(tree_leaves(mixed), tree_leaves(exact.params)))
    assert err <= bound


# ---------------------------------------------------------------------------
# floating-root placement
# ---------------------------------------------------------------------------

def test_group_homes_match_reference():
    rng = np.random.default_rng(10)
    for _ in range(5):
        owner = {s: int(rng.integers(0, 3)) for s in range(8)}
        edges = {s: [f"edge-{int(e)}" for e in rng.integers(0, 6, 2)]
                 for s in range(8) if rng.random() < 0.8}
        assert agg_tree.group_homes(owner, edges) == \
            r_tree.group_homes(owner, edges)
    assert agg_tree.group_homes(
        {0: 1, 1: 0, 2: 1},
        {0: ["edge-3"], 1: ["edge-0", "edge-2"], 2: ["edge-1"]}) == \
        {0: "edge-0", 1: "edge-1"}


def test_link_cost_matches_reference():
    links = {"a": LinkModel(bandwidth_bps=1e6, latency_s=0.5)}
    r_links = {"a": RefLink(bandwidth_bps=1e6, latency_s=0.5)}
    assert agg_tree.link_cost(links, "a", "a", 1e9) == 0.0
    for nb in (0.0, 1e6, 123456789.0):
        assert agg_tree.link_cost(links, "a", "b", nb) == \
            r_tree.link_cost(r_links, "a", "b", nb)


def test_place_root_matches_reference():
    rng = np.random.default_rng(12)
    bw = [1e9, 1e9, 1e5, 5e8]
    links = {f"edge-{i}": LinkModel(bandwidth_bps=b, latency_s=0.002 * i)
             for i, b in enumerate(bw)}
    r_links = {f"edge-{i}": RefLink(bandwidth_bps=b, latency_s=0.002 * i)
               for i, b in enumerate(bw)}
    for _ in range(10):
        homes = {g: f"edge-{int(e)}" for g, e in
                 enumerate(rng.integers(0, 4, int(rng.integers(1, 5))))}
        nbytes = {g: float(rng.choice([0.0, 10.0, 1e6])) for g in homes}
        assert agg_tree.place_root(homes, nbytes, links) == \
            r_tree.place_root(homes, nbytes, r_links)
    # symmetric costs tie -> the lexicographically-lowest edge
    same = LinkModel(bandwidth_bps=1e9, latency_s=0.002)
    assert agg_tree.place_root({0: "edge-1", 1: "edge-0"},
                               {0: 10.0, 1: 10.0},
                               {"edge-0": same, "edge-1": same})[0] == "edge-0"
    with pytest.raises(ValueError):
        agg_tree.place_root({}, {}, links)
