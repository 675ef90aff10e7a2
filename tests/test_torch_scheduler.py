"""The slice as a whole: the port's FedFly round loop against the JAX
package's on the 4-device / 2-edge VGG-5 testbed, from the same weights,
with the delta migration codec and a mid-round move.

Tolerances: migration count, payload bytes and the link-model transfer
time are exact; round times are exact once each migration's wall-clock
pack and unpack time (real time, which the reference also adds to the
simulated clock) is taken out; losses rtol=1e-4 and final global params
atol=1e-4 (float32 training steps of different frameworks, 4 steps per
client and 2 FedAvg barriers).
"""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro.core.mobility import MobilityTrace as RefTrace
from repro.core.mobility import move_at_round as ref_move
from repro.core.scheduler import FedFlyScheduler as RefScheduler
from repro.data.datasets import synthetic_cifar10 as ref_cifar
from repro.data.loader import Batcher as RefBatcher
from repro.data.partition import balanced as ref_balanced
from repro.models.vgg import VGG5 as RefVGG5
from repro.optim.optimizers import sgd as ref_sgd
from repro.optim.schedules import constant as ref_constant
from repro.runtime import cluster as ref_cluster
from repro_torch.core import split
from repro_torch.core.checkpoint import EdgeCheckpoint
from repro_torch.core.migration import MigrationExecutor
from repro_torch.core.mobility import MobilityTrace, move_at_round
from repro_torch.core.scheduler import FedFlyScheduler
from repro_torch.data.datasets import synthetic_cifar10
from repro_torch.data.loader import Batcher
from repro_torch.data.partition import balanced, by_fraction
from repro_torch.models.vgg import VGG5, params_to_reference
from repro_torch.optim.optimizers import sgd
from repro_torch.optim.schedules import constant
from repro_torch.runtime import cluster
from repro_torch.tree import to_numpy, tree_leaves


def test_data_pipeline_identical_to_reference():
    train, test = synthetic_cifar10(n_train=100, n_test=20, seed=3)
    r_train, r_test = ref_cifar(n_train=100, n_test=20, seed=3)
    np.testing.assert_array_equal(train.images, r_train.images)
    np.testing.assert_array_equal(test.labels, r_test.labels)
    from repro.data.partition import by_fraction as ref_by_fraction
    for got, want in zip(by_fraction(train, [0.5, 0.25]),
                         ref_by_fraction(r_train, [0.5, 0.25])):
        np.testing.assert_array_equal(got.images, want.images)
    for got, want in zip(balanced(train, 3), ref_balanced(r_train, 3)):
        b, rb = Batcher(got, 7, seed=1), RefBatcher(want, 7, seed=1)
        assert b.num_batches == rb.num_batches
        for k, v in b.batch_at(2, 1).items():
            np.testing.assert_array_equal(v, rb.batch_at(2, 1)[k])


@pytest.fixture(scope="module")
def runs():
    """Reference and port schedulers run the same 2 delta-codec rounds
    from the same initial weights."""
    r_train, _ = ref_cifar(n_train=160, n_test=40)
    r_batchers = [RefBatcher(p, 20) for p in ref_balanced(r_train, 4)]
    ref = RefScheduler(
        RefVGG5(), ref_sgd(momentum=0.9),
        ref_cluster.make_testbed_devices(r_batchers),
        ref_cluster.make_testbed_edges(), split_point=2,
        lr_schedule=ref_constant(0.01), link=ref_cluster.WIFI_75MBPS,
        migration_codec="delta", seed=0)
    ref.initialize()
    init = jax.tree.map(np.asarray, ref.global_params)
    r_hist = ref.run(2, RefTrace(ref_move("pi3_1", "edge-A", "edge-B", 1,
                                          0.5)), mode="fedfly")

    train, _ = synthetic_cifar10(n_train=160, n_test=40)
    batchers = [Batcher(p, 20) for p in balanced(train, 4)]
    port = FedFlyScheduler(
        VGG5(device="cpu"), sgd(momentum=0.9),
        cluster.make_testbed_devices(batchers), cluster.make_testbed_edges(),
        split_point=2, lr_schedule=constant(0.01), link=cluster.WIFI_75MBPS,
        migration_codec="delta", seed=0, device="cpu")
    port.initialize(init)
    p_hist = port.run(2, MobilityTrace(move_at_round(
        "pi3_1", "edge-A", "edge-B", 1, 0.5)), mode="fedfly")
    return ref, r_hist, port, p_hist


def _wall_terms(rec, client):
    return sum(m.pack_s + m.unpack_s for m in rec.migrations
               if m.client_id == client)


def test_migrations_match_reference(runs):
    ref, r_hist, port, p_hist = runs
    assert len(port.migrator.reports) == len(ref.migrator.reports) == 1
    p, r = port.migrator.reports[0], ref.migrator.reports[0]
    assert (p.client_id, p.src_edge, p.dst_edge, p.codec) == \
        (r.client_id, r.src_edge, r.dst_edge, r.codec)
    assert p.nbytes == r.nbytes
    assert p.base_version == r.base_version == "v1"
    assert p.sim_transfer_s == r.sim_transfer_s
    assert 0 < p.quant_error < 1e-3 and np.isfinite(p.quant_error)


def test_round_times_match_reference(runs):
    _, r_hist, _, p_hist = runs
    for pr, rr in zip(p_hist.rounds, r_hist.rounds):
        assert pr.client_times_sim.keys() == rr.client_times_sim.keys()
        for c in rr.client_times_sim:
            assert (pr.client_times_sim[c] - _wall_terms(pr, c)
                    == pytest.approx(rr.client_times_sim[c]
                                     - _wall_terms(rr, c), rel=1e-12))


def test_losses_and_final_params_match_reference(runs):
    ref, r_hist, port, p_hist = runs
    for pr, rr in zip(p_hist.rounds, r_hist.rounds):
        for c, v in rr.client_losses.items():
            assert pr.client_losses[c] == pytest.approx(v, rel=1e-4)
    got = to_numpy(params_to_reference(port.global_params))
    want = jax.tree.map(np.asarray, ref.global_params)
    for g, w in zip(got, want):
        for k in ("w", "b"):
            np.testing.assert_allclose(g[k], w[k], atol=1e-4, rtol=0)


def test_raw_migration_resume_is_bit_identical():
    """The quickstart's claim on the port: after a raw-codec move, the
    next step from the restored state equals the step from the state that
    never moved, bit for bit."""
    model = VGG5(device="cpu")
    opt = sgd(momentum=0.9)
    params = model.init(torch.Generator().manual_seed(0))
    dev, srv = split.partition_params(model, params, 2)
    dev_opt, srv_opt = opt.init(dev), opt.init(srv)
    g = torch.Generator().manual_seed(1)
    batch = {"images": torch.randn(8, 32, 32, 3, generator=g),
             "labels": torch.randint(0, 10, (8,), generator=g)}

    def step(dev, srv, dev_opt, srv_opt):
        loss, g_dev, g_srv = split.split_value_and_grad(model, dev, srv,
                                                        batch, 2)
        dev, dev_opt = opt.update(g_dev, dev_opt, dev, 0.01)
        srv, srv_opt = opt.update(g_srv, srv_opt, srv, 0.01)
        return dev, srv, dev_opt, srv_opt, loss

    for _ in range(3):
        dev, srv, dev_opt, srv_opt, loss = step(dev, srv, dev_opt, srv_opt)
    ck = EdgeCheckpoint(client_id="device-0", round_idx=0, epoch=0,
                        batch_idx=3, split_point=2, server_params=srv,
                        optimizer_state=srv_opt, loss=float(loss))
    restored, report = MigrationExecutor(device="cpu").migrate(
        ck, "edge-A", "edge-B")
    assert report.nbytes > 0 and report.quant_error == 0.0
    a = step(dev, srv, dev_opt, srv_opt)
    b = step(dev, restored.server_params, dev_opt, restored.optimizer_state)
    for x, y in zip(tree_leaves(a[:4]), tree_leaves(b[:4])):
        assert torch.equal(x, y)


def test_entry_points_refuse_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VGG5()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MigrationExecutor()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FedFlyScheduler(VGG5(device="cpu"), sgd(), [], [], split_point=2,
                        lr_schedule=constant(0.01))


def test_train_launcher_runs_on_cpu(caplog):
    from repro_torch.launch import train
    caplog.set_level("INFO")
    train.main(["--device", "cpu", "--rounds", "1", "--samples", "160",
                "--batch-size", "20", "--codec", "delta",
                "--move-client", "pi3_1", "--move-round", "0",
                "--eval-every", "1"])
    text = caplog.text
    assert "migrated pi3_1 edge-A->edge-B" in text
    assert "eval acc" in text


def test_migration_spans_recorded_when_enabled():
    from repro_torch.obs import telemetry
    model = VGG5(device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    _, srv = split.partition_params(model, params, 2)
    ck = EdgeCheckpoint(client_id="c", round_idx=0, epoch=0, batch_idx=0,
                        split_point=2, server_params=srv,
                        optimizer_state=sgd().init(srv))
    telemetry.enable()
    try:
        MigrationExecutor(codec="delta", device="cpu").migrate(ck, "a", "b")
    finally:
        telemetry.disable()
    names = [s[0] for s in telemetry.snapshot()]
    assert names == ["mig.quantize", "mig.pack", "mig.unpack"]
    MigrationExecutor(device="cpu").migrate(ck, "a", "b")
    assert telemetry.snapshot() == []          # off: nothing recorded
