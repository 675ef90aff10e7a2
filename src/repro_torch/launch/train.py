"""Training launcher (testbed mode): the paper's system end to end on the
card — simulated devices + edge servers, split training of VGG-5, a
mobility trace, migration (FedFly) or restart (SplitFed).

  PYTHONPATH=src python -m repro_torch.launch.train --mode testbed \\
      --device cuda --rounds 5 --move-client pi3_1 --move-round 2 \\
      --move-fraction 0.5 --codec delta

The reference's ``--mode spmd`` is not ported yet.
"""
from __future__ import annotations

import argparse
import logging

import numpy as np
import torch

from repro_torch.core.mobility import MobilityTrace, move_at_round
from repro_torch.core.scheduler import FedFlyScheduler
from repro_torch.data.datasets import synthetic_cifar10
from repro_torch.data.loader import Batcher
from repro_torch.data.partition import balanced, by_fraction
from repro_torch.device import resolve_device
from repro_torch.models.vgg import VGG5
from repro_torch.optim.optimizers import sgd
from repro_torch.optim.schedules import constant
from repro_torch.runtime.cluster import (WIFI_75MBPS, make_testbed_devices,
                                         make_testbed_edges)

log = logging.getLogger("repro_torch.launch.train")


def run_testbed(args) -> None:
    device = resolve_device(args.device)
    train, test = synthetic_cifar10(n_train=args.samples,
                                    n_test=args.samples // 5)
    if args.mobile_fraction > 0:
        rest = (1.0 - args.mobile_fraction) / 3
        parts = by_fraction(train, [args.mobile_fraction, rest, rest, rest])
    else:
        parts = balanced(train, 4)
    batchers = [Batcher(p, args.batch_size) for p in parts]

    model = VGG5(device=device)
    sched = FedFlyScheduler(
        model, sgd(momentum=0.9), make_testbed_devices(batchers),
        make_testbed_edges(), split_point=args.split_point,
        lr_schedule=constant(args.lr), link=WIFI_75MBPS,
        migration_codec=args.codec, seed=args.seed, device=device)
    sched.initialize()

    trace = None
    if args.move_client:
        trace = MobilityTrace(move_at_round(
            args.move_client, "edge-A", "edge-B", args.move_round,
            fraction=args.move_fraction))

    test_batch = {"images": torch.from_numpy(test.images[:1024]).to(device),
                  "labels": torch.from_numpy(test.labels[:1024]).to(device)}

    def eval_fn(params):
        with torch.no_grad():
            return float(model.accuracy(params, test_batch))

    hist = sched.run(args.rounds, trace, mode=args.fl_mode,
                     eval_fn=eval_fn, eval_every=args.eval_every)
    for r in hist.rounds:
        mig = "".join(f" [migrated {m.client_id} {m.src_edge}->{m.dst_edge} "
                      f"{m.nbytes/1e6:.1f}MB {m.sim_total_s:.2f}s]"
                      for m in r.migrations)
        rst = f" [restarted {r.restarted}]" if r.restarted else ""
        log.info("round %3d  sim=%7.2fs  wall=%6.2fs  loss=%.4f%s%s",
                 r.round_idx, r.round_time_sim, r.round_time_wall,
                 np.mean(list(r.client_losses.values())), mig, rst)
        if r.round_idx in hist.eval_acc:
            log.info("          eval acc: %.3f", hist.eval_acc[r.round_idx])
    log.info("total simulated training time: %.1fs  "
             "migration overhead: %.2fs",
             hist.total_time_sim(), sched.migrator.total_overhead_s())


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--mode", choices=("testbed",), default="testbed")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--samples", type=int, default=4000)
    ap.add_argument("--batch-size", type=int, default=100)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--split-point", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fl-mode", choices=("fedfly", "splitfed"),
                    default="fedfly")
    ap.add_argument("--codec", choices=("raw", "int8", "delta"),
                    default="raw")
    ap.add_argument("--mobile-fraction", type=float, default=0.25)
    ap.add_argument("--move-client", default=None)
    ap.add_argument("--move-round", type=int, default=2)
    ap.add_argument("--move-fraction", type=float, default=0.5)
    ap.add_argument("--eval-every", type=int, default=0)
    ap.add_argument("-v", "--verbose", action="store_true")
    ap.add_argument("-q", "--quiet", action="store_true")
    args = ap.parse_args(argv)
    level = (logging.DEBUG if args.verbose else
             logging.WARNING if args.quiet else logging.INFO)
    logging.basicConfig(level=level, format="%(name)s: %(message)s")
    run_testbed(args)


if __name__ == "__main__":
    main()
