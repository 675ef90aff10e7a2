"""The port's fleet (``repro_torch.sim.fleet``) against the reference's
``repro.sim.fleet``: specs, cohort membership and data, one cohort epoch
from the same initial weights, the cohort timing tables, the migration
containers, and a flush window of the epoch's contributions through both
packages' FedAsync aggregators.

Tolerances: specs, membership, data, cost tables, container bytes and
the aggregator fold of identical trees are exact. Trained replicas are
held as ``tests/test_torch_scheduler.py`` holds training: losses
rtol=1e-4, parameters atol=1e-4 (float32 split steps of two frameworks).
The cost tables showed no float32-ulp FLOP deviation at SP2, batch 4
(``tests/test_torch_cost_model.py`` documents one at SP1, B 50 and 100).
"""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro.core.checkpoint import EdgeCheckpoint as RefCheckpoint
from repro.models.vgg import VGG5 as RefVGG5
from repro.optim.optimizers import sgd as ref_sgd
from repro.optim.schedules import constant as ref_constant
from repro.sim import async_agg as r_agg
from repro.sim import fleet as r_fleet
from repro_torch.models.vgg import VGG5, params_from_reference, \
    params_to_reference
from repro_torch.optim.optimizers import sgd
from repro_torch.optim.schedules import constant
from repro_torch.sim import async_agg, fleet
from repro_torch.tree import to_numpy, tree_leaves, tree_map

EDGES = ["edge-0", "edge-1"]
CODECS = ("raw", "int8", "delta")


def _specs(mod, n=6, cohorts=2, batch_size=4, num_batches=1):
    return mod.make_fleet_specs(n, EDGES, batch_size=batch_size,
                                num_batches=num_batches, cohorts=cohorts)


def test_fleet_specs_identical():
    got = _specs(fleet, n=11, cohorts=3, batch_size=16, num_batches=2)
    want = _specs(r_fleet, n=11, cohorts=3, batch_size=16, num_batches=2)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.client_id, g.edge_id, g.num_samples, g.batch_size,
                g.num_batches, g.cohort_key) == (
            w.client_id, w.edge_id, w.num_samples, w.batch_size,
            w.num_batches, w.cohort_key)
        assert (g.profile.name, g.profile.flops_per_s) == (
            w.profile.name, w.profile.flops_per_s)


@pytest.fixture(scope="module")
def fleets():
    """Reference and port fleets (6 clients in 2 cohorts x 2 replicas, so
    clients share replicas; batch 4, 1 and 2 batches per epoch) from the
    reference's initial weights; tables and
    containers taken before training, then one epoch of each cohort."""
    ref = r_fleet.Fleet(RefVGG5(), ref_sgd(momentum=0.9), _specs(r_fleet),
                        split_point=2, lr_schedule=ref_constant(0.01),
                        max_replicas=2, seed=0)
    port = fleet.Fleet(VGG5(device="cpu"), sgd(momentum=0.9),
                       _specs(fleet), split_point=2,
                       lr_schedule=constant(0.01), max_replicas=2, seed=0,
                       device="cpu")
    init = jax.tree.map(np.asarray, ref.global_params)
    port.set_global(params_from_reference(init, "cpu"))
    before = {"tables": {c: (port.cohort_tables(c), ref.cohort_tables(c))
                         for c in CODECS},
              "packs": {c: [(pc.pack(c), _ref_pack(rc, c)) for pc, rc in
                            zip(port.cohorts.values(),
                                ref.cohorts.values())] for c in CODECS}}
    for client in ("dev-0000", "dev-0001"):
        port.ensure_epoch(port.clients[client], 0)
        ref.ensure_epoch(ref.clients[client], 0)
    return ref, port, before


def _torch(tree):
    return tree_map(lambda x: torch.from_numpy(np.array(x)), tree)


def _ref_pack(cohort, codec):
    """The container the reference's ``Cohort.nbytes`` measures."""
    srv = jax.tree.map(lambda x: np.asarray(x[0]), cohort._srv)
    opt = jax.tree.map(lambda x: np.asarray(x[0]), cohort._srv_opt)
    ck = RefCheckpoint(client_id="cohort", round_idx=0, epoch=0,
                       batch_idx=0, split_point=cohort.sp,
                       server_params=srv, optimizer_state=opt)
    base = {"server_params": srv} if codec == "delta" else None
    return ck.pack(codec, base=base, base_version="cohort-table")


def test_cohort_membership_and_data_identical(fleets):
    ref, port, _ = fleets
    assert list(port.cohorts) == list(ref.cohorts) == [(4, 1), (4, 2)]
    for key, pc in port.cohorts.items():
        rc = ref.cohorts[key]
        assert pc.replicas == rc.replicas == 2
        for pb, rb in zip(pc.batchers, rc.batchers):
            for b in range(pc.num_batches):
                for k, v in pb.batch_at(0, b).items():
                    np.testing.assert_array_equal(v, rb.batch_at(0, b)[k])
    assert {c: (s.replica, s.spec.cohort_key)
            for c, s in port.clients.items()} == \
        {c: (s.replica, s.spec.cohort_key) for c, s in ref.clients.items()}
    assert port.cohort_sizes() == ref.cohort_sizes()
    assert port.num_clients == ref.num_clients == 6


@pytest.mark.parametrize("codec", CODECS)
def test_cohort_tables_and_containers_identical(fleets, codec):
    _, _, before = fleets
    got, want = before["tables"][codec]
    assert got == want
    for p_bytes, r_bytes in before["packs"][codec]:
        assert p_bytes == r_bytes


def test_cohort_epoch_matches_reference(fleets):
    ref, port, _ = fleets
    for key, pc in port.cohorts.items():
        rc = ref.cohorts[key]
        np.testing.assert_allclose(pc.losses[0], rc.losses[0], rtol=1e-4)
        for p_tree, r_tree in zip(pc.snapshots[0], rc.snapshots[0]):
            for g, w in zip(tree_leaves(to_numpy(params_to_reference(
                    p_tree))), jax.tree.leaves(r_tree)):
                np.testing.assert_allclose(g, np.asarray(w), atol=1e-4,
                                           rtol=0)
        # after training the payload sizes and batch costs still agree
        assert pc.nbytes("delta") == rc.nbytes("delta")
        cid = next(c for c, s in port.clients.items()
                   if s.spec.cohort_key == key)
        assert port.batch_costs(port.clients[cid]) == \
            ref.batch_costs(ref.clients[cid])
        assert port.payload_nbytes(port.clients[cid], "raw") == \
            ref.payload_nbytes(ref.clients[cid], "raw")
    assert {k: (s.key, s.replicas, s.sp, s.seed)
            for k, s in port.cohort_specs().items()} == \
        {k: (s.key, s.replicas, s.sp, s.seed)
         for k, s in ref.cohort_specs().items()}
    got_base = to_numpy(port.migration_base())
    want_base = ref.migration_base()
    for g, w in zip(tree_leaves(got_base), jax.tree.leaves(want_base)):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_flush_window_of_contributions_matches_reference(fleets):
    """The slice end to end: every client's contribution of the epoch in
    one FedAsync window. Fed the reference's own replica trees, the port's
    exact fold commits the reference's bits; fed the port's trained
    replicas, it lands within the training tolerance."""
    ref, port, _ = fleets
    rng = np.random.default_rng(0)
    stale = [int(s) for s in rng.integers(0, 12, port.num_clients)]
    r_window, p_window, mirrored = [], [], {}
    for (cid, rc), s in zip(ref.clients.items(), stale):
        r_tree, _ = ref.contribution(rc, 0)
        p_tree, _ = port.contribution(port.clients[cid], 0)
        r_window.append((r_tree, rc.spec.num_samples, s))
        p_window.append((p_tree, rc.spec.num_samples, s))
        # the reference tree as a torch tree, one object per replica tree
        mirrored.setdefault(id(r_tree), _torch(r_tree))
    m_window = [(mirrored[id(t)], w, s) for t, w, s in r_window]
    init = jax.tree.map(np.asarray, ref.global_params)
    r_a = r_agg.AsyncAggregator(init, alpha=0.6, staleness_fn=(
        r_agg.hinge_staleness(a=0.5, b=4.0)))
    m_a, p_a = (async_agg.AsyncAggregator(
        start, alpha=0.6, staleness_fn=async_agg.hinge_staleness(a=0.5, b=4.0))
        for start in (_torch(init), port.global_params))
    assert r_a.flush_batch(r_window) == m_a.flush_batch(m_window) == \
        p_a.flush_batch(p_window)
    for m, r in zip(tree_leaves(m_a.params), jax.tree.leaves(r_a.params)):
        np.testing.assert_array_equal(m.numpy(), np.asarray(r))
    for p, r in zip(tree_leaves(to_numpy(params_to_reference(p_a.params))),
                    jax.tree.leaves(r_a.params)):
        np.testing.assert_allclose(p, np.asarray(r), atol=1e-4, rtol=0)
    assert p_a.version == r_a.version == port.num_clients


def test_cohort_spec_rebuilds_and_pruned_epoch_raises():
    spec = fleet.CohortSpec(key=(4, 1), replicas=2, sp=2, seed=0,
                            model=VGG5(device="cpu"),
                            optimizer=sgd(momentum=0.9), device="cpu")
    cohort = spec.build()
    assert (cohort.key, cohort.replicas, cohort.device.type) == \
        ((4, 1), 2, "cpu")
    assert cohort.spec() == spec
    cohort.prune(1)
    assert cohort.floor == 1
    with pytest.raises(fleet.PrunedEpochError):
        cohort.run_epoch(cohort.model.init(), 0, 0.01)


def test_fleet_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fleet.Fleet(VGG5(device="cpu"), sgd(), _specs(fleet),
                    split_point=2, lr_schedule=constant(0.01))
