"""Migration executor — FedFly's Steps 6-9 (Fig. 2).

``MigrationExecutor.migrate`` takes the source edge's ``EdgeCheckpoint``,
packs it (raw, int8 or delta codec), moves the bytes, and unpacks at the
destination on ``device``. Byte movement goes through one of:

  direct        — edge→edge (paper default)
  device_relay  — edge→device→edge (paper fallback when edges cannot
                  talk to each other); two link traversals on the
                  simulated clock.
  send/recv     — a caller-supplied byte channel, wall-clock timed; a
                  ``stream_send`` hook ships ``pack_chunks`` instead, so
                  serialization overlaps the transfer.

With the delta codec, residuals are encoded against the newest base
version the destination edge has synced (``BaseVersionRegistry``).

Every migration returns a ``MigrationReport`` with wall-clock pack/
transfer/unpack times (on the card: up to the point the restored
tensors are ready) and the simulated-testbed transfer time of the link
model — the quantity the paper's "≤2 s overhead" claim refers to.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Iterable, Optional

import torch

from repro_torch.core.checkpoint import EdgeCheckpoint
from repro_torch.device import resolve_device, synchronize
from repro_torch.obs import telemetry as obs
from repro_torch.runtime.checkpoint_manager import BaseVersionRegistry
from repro_torch.runtime.transport import LinkModel
from repro_torch.tree import tree_leaves

Params = Any


@dataclass
class MigrationReport:
    client_id: str
    src_edge: str
    dst_edge: str
    nbytes: int
    codec: str
    route: str                 # "direct" | "device_relay"
    pack_s: float
    transfer_s: float          # wall clock (0 if no real transport)
    unpack_s: float
    sim_transfer_s: float      # link-model time (the paper's overhead)
    quant_error: float = 0.0   # max abs param error introduced by codec
    base_version: Optional[str] = None   # delta: base the payload rides on
    overlapped: bool = False   # pack streamed into the transfer

    @property
    def wall_total_s(self) -> float:
        return self.pack_s + self.transfer_s + self.unpack_s

    @property
    def sim_total_s(self) -> float:
        return self.pack_s + self.sim_transfer_s + self.unpack_s


def max_abs_error(a: Params, b: Params) -> float:
    """max |a - b| over matching leaves (tensors or numpy arrays), in
    float32 (0.0 for no leaves)."""
    pairs = [(torch.as_tensor(x), torch.as_tensor(y))
             for x, y in zip(tree_leaves(a), tree_leaves(b))]
    errs = [(x.to(y.device).float() - y.float()).abs().max()
            for x, y in pairs if x.numel()]
    return float(torch.stack(errs).max()) if errs else 0.0


class MigrationExecutor:
    """Moves one device's server-stage training state between edges."""

    def __init__(self, link: LinkModel = LinkModel(), codec: str = "raw",
                 send: Optional[Callable[[str, bytes], None]] = None,
                 recv: Optional[Callable[[str], bytes]] = None,
                 base_registry: Optional[BaseVersionRegistry] = None,
                 stream_send: Optional[Callable[[str, Iterable[bytes]],
                                                int]] = None,
                 device="cuda"):
        self.link = link
        self.codec = codec
        self._send = send
        self._recv = recv
        self._stream_send = stream_send
        self.base_registry = base_registry
        self.device = resolve_device(device)
        self.reports: list[MigrationReport] = []

    def migrate(self, ckpt: EdgeCheckpoint, src_edge: str, dst_edge: str,
                route: str = "direct", *, base: Params = None,
                base_version: Optional[str] = None
                ) -> tuple[EdgeCheckpoint, MigrationReport]:
        if (self.codec == "delta" and base is None
                and self.base_registry is not None):
            base, base_version = self.base_registry.base_for(dst_edge)
        dev = self.device

        overlapped = self._stream_send is not None and self._recv is not None
        synchronize(dev)
        t0 = time.perf_counter()
        if overlapped:
            with obs.span("mig.transfer", client=ckpt.client_id,
                          codec=self.codec, overlapped=True):
                nbytes = self._stream_send(
                    dst_edge, ckpt.pack_chunks(self.codec, base=base,
                                               base_version=base_version,
                                               device=dev))
                t1 = time.perf_counter()
                payload_rx = self._recv(dst_edge)
        else:
            with obs.span("mig.pack", client=ckpt.client_id,
                          codec=self.codec):
                payload = ckpt.pack(self.codec, base=base,
                                    base_version=base_version, device=dev)
            nbytes = len(payload)
            t1 = time.perf_counter()
            if self._send is not None and self._recv is not None:
                with obs.span("mig.transfer", client=ckpt.client_id,
                              nbytes=nbytes):
                    self._send(dst_edge, payload)
                    payload_rx = self._recv(dst_edge)
            else:
                payload_rx = payload
        t2 = time.perf_counter()

        with obs.span("mig.unpack", client=ckpt.client_id):
            restored = EdgeCheckpoint.unpack(payload_rx, base=base,
                                             device=dev)
            synchronize(dev)
        t3 = time.perf_counter()

        hops = 2 if route == "device_relay" else 1
        sim_transfer = hops * self.link.transfer_time(nbytes)

        qerr = 0.0
        if self.codec != "raw":
            qerr = max_abs_error(ckpt.server_params, restored.server_params)

        report = MigrationReport(
            client_id=ckpt.client_id, src_edge=src_edge, dst_edge=dst_edge,
            nbytes=nbytes, codec=self.codec, route=route,
            # overlapped: pack rode inside the transfer, clock it there
            pack_s=0.0 if overlapped else t1 - t0,
            transfer_s=t2 - (t0 if overlapped else t1), unpack_s=t3 - t2,
            sim_transfer_s=sim_transfer, quant_error=qerr,
            base_version=base_version, overlapped=overlapped)
        self.reports.append(report)
        return restored, report

    def total_overhead_s(self) -> float:
        return sum(r.sim_total_s for r in self.reports)
