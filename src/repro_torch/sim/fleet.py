"""Cohort-grouped fleet state: thousands of clients, O(cohorts) training
(``repro.sim.fleet``'s counterpart, on the card).

Clients sharing a *cohort signature* ``(batch size, batches per epoch)``
are backed by a small stack of ``replicas`` model instances; the cost
model runs once per cohort instead of once per client. With
``max_replicas >= fleet size`` every client owns a private replica and
the numerics are exactly per-client split training; at fleet scale the
replicas per cohort are capped, so clients mapped to the same replica
share one parameter trajectory for the epoch, while the timing layer
still treats every client individually.

Numerics follow ``core.scheduler``: each local epoch starts from the
current global model (re-broadcast), optimizer state persists per
replica, and the post-epoch merged model is the client's update. The
reference advances the replicas with one ``jax.vmap``-ed step; here a
loop over the (at most a few) replicas runs the port's split step
(``core.split.split_value_and_grad``, two autograd passes), the same
per-replica computation.

Parameter trees are in torch layout on the fleet's device; migration
containers are packed in the reference layout, so their bytes are the
reference's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import split as split_lib
from repro_torch.core.checkpoint import EdgeCheckpoint
from repro_torch.core.mobility import MoveEvent
from repro_torch.data.datasets import synthetic_cifar10
from repro_torch.data.loader import Batcher
from repro_torch.data.partition import balanced
from repro_torch.device import resolve_device
from repro_torch.models.vgg import params_to_reference
from repro_torch.optim.optimizers import Optimizer
from repro_torch.runtime.cluster import (PI3, PI4, HardwareProfile,
                                         StageCostModel)
from repro_torch.tree import tree_leaves, tree_map

Params = Any


def tree_nbytes(tree: Params) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


# ---------------------------------------------------------------------------
# client specs + runtime state
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ClientSpec:
    client_id: str
    profile: HardwareProfile
    edge_id: str                    # initial attachment
    num_samples: int = 600          # FedAvg weight (dataset size)
    batch_size: int = 16
    num_batches: int = 2            # batches per local epoch

    @property
    def cohort_key(self) -> Tuple[int, int]:
        return (self.batch_size, self.num_batches)


@dataclass
class SimClient:
    spec: ClientSpec
    replica: int
    edge_id: str                    # current attachment (moves!)
    epoch: int = 0                  # local epoch currently running
    batch_idx: int = 0
    epochs_done: int = 0
    version_at_start: int = 0       # aggregator version the epoch started from
    epoch_start_s: float = 0.0
    pending_move: Optional[MoveEvent] = None
    move_at: int = -1               # batch index at which the move fires
    migrating: bool = False
    done: bool = False

    @property
    def client_id(self) -> str:
        return self.spec.client_id


def make_fleet_specs(num_clients: int, edge_ids: Sequence[str], *,
                     batch_size: int = 16, num_batches: int = 2,
                     samples_per_client: int = 600,
                     profiles: Sequence[HardwareProfile] = (PI3, PI4),
                     cohorts: int = 1) -> List[ClientSpec]:
    """Uniform fleet, clients dealt round-robin onto edges.
    ``cohorts > 1`` spreads clients over that many cohort signatures
    (cycling ``num_batches`` upward)."""
    return [ClientSpec(client_id=f"dev-{i:04d}",
                       profile=profiles[i % len(profiles)],
                       edge_id=edge_ids[i % len(edge_ids)],
                       num_samples=samples_per_client,
                       batch_size=batch_size,
                       num_batches=num_batches + (i % max(cohorts, 1)))
            for i in range(num_clients)]


# ---------------------------------------------------------------------------
# cohorts
# ---------------------------------------------------------------------------

class PrunedEpochError(RuntimeError):
    """A pruned (cohort, epoch) was re-requested. Retraining it would
    silently use optimizer state that has drifted past that epoch, so the
    protocol surfaces the straggler bug loudly instead."""


@dataclass(frozen=True)
class CohortSpec:
    """Everything needed to rebuild a ``Cohort`` in another process.
    Picklable: the model is a plain object and ``Optimizer`` reduces to
    its (factory, kwargs) conf."""
    key: Tuple[int, int]
    replicas: int
    sp: int
    seed: int
    model: Any
    optimizer: Any
    device: str = "cuda"

    def build(self) -> "Cohort":
        return Cohort(self.key, self.model, self.optimizer, self.sp,
                      self.replicas, self.seed, device=self.device)


class Cohort:
    """``replicas`` split-model instances advanced through each local
    epoch on ``device``."""

    def __init__(self, key: Tuple[int, int], model, optimizer: Optimizer,
                 sp: int, replicas: int, seed: int, *, device="cuda"):
        self.device = resolve_device(device)
        self.key = key
        self.batch_size, self.num_batches = key
        self.model = model
        self.opt = optimizer
        self.sp = sp
        self.replicas = replicas
        self._seed = seed
        # per-replica private data: each replica's epoch is exactly
        # num_batches batches (the reference's seeding, byte for byte)
        n = replicas * self.batch_size * self.num_batches
        train, _ = synthetic_cifar10(n_train=n, n_test=1,
                                     seed=seed + 7919 * hash(key) % 10007)
        self.batchers = [Batcher(p, self.batch_size, seed=seed)
                         for p in balanced(train, replicas, seed=seed)]
        # per-replica stage params and optimizer state (which persists)
        self._dev: Optional[List[Params]] = None
        self._srv: Optional[List[Params]] = None
        self._dev_opt: Optional[List[Params]] = None
        self._srv_opt: Optional[List[Params]] = None
        self.snapshots: Dict[int, List[Params]] = {}  # epoch -> trees
        self.losses: Dict[int, np.ndarray] = {}       # epoch -> (R,)
        self.floor = 0                                # epochs < floor pruned
        self._costs: Optional[Tuple[float, float, int]] = None
        self._nbytes: Dict[str, Dict[str, int]] = {}   # codec -> sizes

    def _stages(self, global_params: Params) -> Tuple[Params, Params]:
        params = tree_map(lambda t: t.to(self.device), global_params)
        return split_lib.partition_params(self.model, params, self.sp)

    def _batch(self, replica: int, epoch: int, b: int) -> Dict[str, Any]:
        return {k: torch.from_numpy(v).to(self.device) for k, v in
                self.batchers[replica].batch_at(epoch, b).items()}

    # -- the whole-cohort epoch ------------------------------------------

    def ensure_stages(self, global_params: Params):
        """Materialize the per-replica stage and optimizer state from the
        global model. Runs before any costs()/nbytes() query: the timing
        layer asks for payload sizes before the first epoch trains."""
        if self._dev is not None:
            return
        dev1, srv1 = self._stages(global_params)
        R = self.replicas
        self._dev, self._srv = [dev1] * R, [srv1] * R
        self._dev_opt = [self.opt.init(dev1) for _ in range(R)]
        self._srv_opt = [self.opt.init(srv1) for _ in range(R)]

    def run_epoch(self, global_params: Params, epoch: int, lr: float):
        """Advance all replicas through local epoch ``epoch``, starting
        from the current global model (Step 1/6 re-broadcast). The
        optimizer returns new tensors, so replicas may start from the same
        global tensors."""
        if epoch in self.snapshots:
            return
        if epoch < self.floor:
            raise PrunedEpochError(
                f"cohort {self.key} epoch {epoch} was already pruned "
                f"(floor {self.floor}): a straggler re-requested a retired "
                "epoch, and retraining it would silently reuse optimizer "
                "state that advanced past it")
        self.ensure_stages(global_params)   # opt state on first call
        dev1, srv1 = self._stages(global_params)
        snaps, losses = [], []
        for r in range(self.replicas):
            dev, srv = dev1, srv1
            dev_opt, srv_opt = self._dev_opt[r], self._srv_opt[r]
            loss = torch.zeros((), device=self.device)
            for b in range(self.num_batches):
                loss, g_dev, g_srv = split_lib.split_value_and_grad(
                    self.model, dev, srv, self._batch(r, epoch, b), self.sp)
                dev, dev_opt = self.opt.update(g_dev, dev_opt, dev, lr)
                srv, srv_opt = self.opt.update(g_srv, srv_opt, srv, lr)
            self._dev[r], self._srv[r] = dev, srv
            self._dev_opt[r], self._srv_opt[r] = dev_opt, srv_opt
            snaps.append(split_lib.merge_params(self.model, dev, srv))
            losses.append(loss)
        self.snapshots[epoch] = snaps
        self.losses[epoch] = torch.stack(losses).float().cpu().numpy()

    def prune(self, min_live_epoch: int):
        """Drop snapshots no straggler can still contribute. A later
        ``run_epoch`` below the new floor raises ``PrunedEpochError``."""
        for e in [e for e in self.snapshots if e < min_live_epoch]:
            del self.snapshots[e]
            del self.losses[e]
        self.floor = max(self.floor, min_live_epoch)

    def spec(self) -> CohortSpec:
        return CohortSpec(key=self.key, replicas=self.replicas, sp=self.sp,
                          seed=self._seed, model=self.model,
                          optimizer=self.opt, device=str(self.device))

    # -- cost model (once per cohort, not per client) --------------------

    def costs(self, cost_model: StageCostModel) -> Tuple[float, float, int]:
        """(device fwd FLOPs, server fwd FLOPs, smashed bytes) for ONE
        client's batch."""
        if self._costs is None:
            self._costs = cost_model.costs(
                self.model, self._dev[0], self._srv[0],
                self.batchers[0].batch_at(0, 0), self.sp)
        return self._costs

    def pack(self, codec: str = "raw") -> bytes:
        """The cohort's representative migration container under
        ``codec``: replica 0's server stage and optimizer state in the
        reference layout, as a real ``EdgeCheckpoint.pack`` puts them on
        the backhaul (delta against the stage itself)."""
        srv = params_to_reference(self._srv[0])
        ck = EdgeCheckpoint(
            client_id="cohort", round_idx=0, epoch=0, batch_idx=0,
            split_point=self.sp, server_params=srv,
            optimizer_state=params_to_reference(self._srv_opt[0]))
        base = {"server_params": srv} if codec == "delta" else None
        return ck.pack(codec, base=base, base_version="cohort-table",
                       device=self.device)

    def nbytes(self, codec: str = "raw") -> Dict[str, int]:
        """Payload sizes used by the timing layer. ``ckpt`` is the
        *encoded* migration container size under ``codec`` (int8/delta
        sizes are value-independent apart from the lossy-residual
        fallback, so one representative pack prices every migration of
        the cohort). ``dev``/``update`` stay raw: model broadcast and
        update upload are not quantized."""
        if codec not in self._nbytes:
            dev1, srv1 = self._dev[0], self._srv[0]
            self._nbytes[codec] = {
                "dev": tree_nbytes(dev1),
                "update": tree_nbytes(dev1) + tree_nbytes(srv1),
                "ckpt": len(self.pack(codec)),
            }
        return self._nbytes[codec]

    def server_state_for(self, replica: int) -> Tuple[Params, Params]:
        """Current server-stage (params, opt state) of one replica — the
        payload an ``EdgeCheckpoint`` carries during migration."""
        return self._srv[replica], self._srv_opt[replica]


# ---------------------------------------------------------------------------
# the fleet
# ---------------------------------------------------------------------------

class Fleet:
    """All simulated clients, grouped into cohorts, trained on
    ``device``."""

    def __init__(self, model, optimizer: Optimizer, specs: Sequence[ClientSpec],
                 *, split_point: int, lr_schedule, max_replicas: int = 8,
                 seed: int = 0, device="cuda"):
        self.device = resolve_device(device)
        self.model = model
        self.sp = split_point
        self.lr_schedule = lr_schedule
        self.seed = seed
        self.global_params: Params = tree_map(
            lambda t: t.to(self.device),
            model.init(torch.Generator().manual_seed(seed)))
        self.cost_model = StageCostModel()
        self._mig_base: Optional[Tuple[Params, Params]] = None

        by_key: Dict[Tuple[int, int], List[ClientSpec]] = {}
        for s in specs:
            by_key.setdefault(s.cohort_key, []).append(s)
        self.cohorts: Dict[Tuple[int, int], Cohort] = {}
        self.clients: Dict[str, SimClient] = {}
        for key, members in sorted(by_key.items()):
            R = min(len(members), max_replicas)
            self.cohorts[key] = Cohort(key, model, optimizer, split_point,
                                       R, seed, device=self.device)
            for i, s in enumerate(members):
                self.clients[s.client_id] = SimClient(
                    spec=s, replica=i % R, edge_id=s.edge_id)

    # -- numerics --------------------------------------------------------

    def set_global(self, tree: Params):
        """Install the aggregator's new global model (a tree of tensors
        in torch layout). Moved to the device once per cohort epoch in
        ``run_epoch``, not per async update arrival."""
        self.global_params = tree

    def ensure_epoch(self, client: SimClient, epoch: int):
        """Materialize the cohort's epoch (no-op if already run)."""
        cohort = self.cohorts[client.spec.cohort_key]
        if epoch in cohort.snapshots:
            return
        cohort.run_epoch(self.global_params, epoch,
                         self.lr_schedule(epoch))
        live = min((c.epoch for c in self.clients.values()
                    if c.spec.cohort_key == client.spec.cohort_key
                    and not c.done), default=epoch)
        cohort.prune(live)

    def contribution(self, client: SimClient, epoch: int
                     ) -> Tuple[Params, float]:
        """(merged update tree, final loss) for one client's epoch."""
        cohort = self.cohorts[client.spec.cohort_key]
        return (cohort.snapshots[epoch][client.replica],
                float(cohort.losses[epoch][client.replica]))

    # -- timing inputs ---------------------------------------------------

    def batch_costs(self, client: SimClient) -> Tuple[float, float, int]:
        cohort = self.cohorts[client.spec.cohort_key]
        cohort.ensure_stages(self.global_params)
        return cohort.costs(self.cost_model)

    def cohort_tables(self, codec: str = "raw"
                      ) -> Dict[Tuple[int, int], Dict[str, float]]:
        """Static per-cohort timing table (FLOPs + payload bytes) — the
        only numerics the shard engines ever see, as plain floats.
        ``ckpt`` is priced from the *encoded* migration payload under
        ``codec``."""
        out: Dict[Tuple[int, int], Dict[str, float]] = {}
        for key, cohort in sorted(self.cohorts.items()):
            cohort.ensure_stages(self.global_params)
            dflops, sflops, sbytes = cohort.costs(self.cost_model)
            out[key] = {"dflops": float(dflops), "sflops": float(sflops),
                        "sbytes": float(sbytes),
                        **{k: float(v)
                           for k, v in cohort.nbytes(codec).items()}}
        return out

    def cohort_specs(self) -> Dict[Tuple[int, int], CohortSpec]:
        """Rebuildable spec per cohort."""
        return {key: c.spec() for key, c in self.cohorts.items()}

    def cohort_sizes(self) -> Dict[Tuple[int, int], int]:
        """Clients per cohort (for snapshot-pruning bookkeeping)."""
        sizes: Dict[Tuple[int, int], int] = {}
        for c in self.clients.values():
            sizes[c.spec.cohort_key] = sizes.get(c.spec.cohort_key, 0) + 1
        return sizes

    def payload_nbytes(self, client: SimClient,
                       codec: str = "raw") -> Dict[str, int]:
        cohort = self.cohorts[client.spec.cohort_key]
        cohort.ensure_stages(self.global_params)
        return cohort.nbytes(codec)

    def migration_base(self) -> Params:
        """Server-stage partition of the current global model in the
        reference layout, mirroring the checkpoint tree — the base every
        edge holds after its last model download (delta codec)."""
        if (self._mig_base is None
                or self._mig_base[0] is not self.global_params):
            params = tree_map(lambda t: t.to(self.device),
                              self.global_params)
            _, s = split_lib.partition_params(self.model, params, self.sp)
            self._mig_base = (self.global_params,
                              {"server_params": params_to_reference(s)})
        return self._mig_base[1]

    @property
    def num_clients(self) -> int:
        return len(self.clients)
