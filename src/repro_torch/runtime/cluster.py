"""Simulated FedFly cluster: devices, edge servers, central server.

Mirrors the paper's lab testbed (§V.A): four Raspberry Pis, two x86 edge
servers, Wi-Fi at 75 Mbps. Hardware profiles carry a sustained-FLOP/s
estimate used by the *simulated clock*; per-batch stage times are

    t = 3 · FLOPs_fwd(stage) / flops_per_s        (fwd + bwd ≈ 3× fwd)
      + link time of the smashed activations (up) and their grads (down)

The reference takes the stage FLOPs from XLA's ``cost_analysis()``; the
port counts them analytically *to XLA's convention* (``StageCostModel``),
so both packages run the same simulated clock.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.data.loader import Batcher
from repro_torch.models.vgg import VGG5
from repro_torch.runtime.transport import LinkModel

Params = Any


# ---------------------------------------------------------------------------
# hardware profiles (paper testbed, §V.A)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class HardwareProfile:
    name: str
    flops_per_s: float


# Sustained practical throughputs (not peak datasheet numbers).
PI3 = HardwareProfile("pi3", 2.4e9)       # 1.2GHz quad Cortex-A53
PI4 = HardwareProfile("pi4", 6.0e9)       # 1.5GHz quad Cortex-A72
EDGE_I5 = HardwareProfile("edge-i5", 6.0e10)
EDGE_I7 = HardwareProfile("edge-i7", 9.0e10)

WIFI_75MBPS = LinkModel(bandwidth_bps=75e6, latency_s=0.005)


# ---------------------------------------------------------------------------
# cluster entities
# ---------------------------------------------------------------------------

@dataclass
class Device:
    client_id: str
    profile: HardwareProfile
    batcher: Batcher
    edge_id: str                      # current attachment
    dev_params: Params = None
    dev_opt: Params = None

    @property
    def num_samples(self) -> int:
        return len(self.batcher.ds)


@dataclass
class ClientServerState:
    """Per-client server-side training state held by an edge server."""
    srv_params: Params
    srv_opt: Params
    epoch: int = 0
    batch_idx: int = 0
    last_loss: float = 0.0
    last_grads: Optional[Params] = None


@dataclass
class EdgeServer:
    edge_id: str
    profile: HardwareProfile
    clients: Dict[str, ClientServerState] = field(default_factory=dict)


# ---------------------------------------------------------------------------
# stage cost model (analytic FLOPs, XLA's counting convention)
# ---------------------------------------------------------------------------

def _layer_flops(kind: str, spec, h: int, w: int, last: bool) -> int:
    """Forward FLOPs of one VGG-5 layer for one sample, counted as XLA's
    CPU ``cost_analysis`` counts the reference's jitted stage:

    * 3x3 SAME conv: 2·Cin·Cout per *in-bounds* tap, (3H-2)(3W-2) taps;
      bias and ReLU one op per output; 2x2 max-pool 3 per pooled output.
    * hidden fc: 2·in·out, bias and ReLU one op per output.
    * last fc + mean NLL over C classes: 2·in·C, then 8C + 6 per sample
      (the fused log-softmax recomputes the bias add in each of its three
      fusions: 3C; max and sum reductions C-1 each; three subtractions
      3C; six integer ops and a select of the label gather; one add of
      the batch mean)."""
    if kind == "conv":
        cin, cout, pool = spec
        f = 2 * cin * cout * (3 * h - 2) * (3 * w - 2) + 2 * h * w * cout
        if pool:
            f += 3 * (h // 2) * (w // 2) * cout
        return f
    fin, fout = spec
    if last:
        return 2 * fin * fout + 8 * fout + 6
    return 2 * fin * fout + 2 * fout


def _loss_batch_terms(batch: int) -> int:
    """Batch-size terms of the mean: the reduction's output op and the
    scale and negate (+1 in all), and XLA's vectorized reduction over the
    batch, which counts the batch padded to a multiple of 32 once it is
    longer than 32."""
    pad = (-batch) % 32 if batch > 32 else 0
    return 1 + pad


def _xla_sum(flops: int) -> float:
    # XLA adds its per-instruction counts in float32, in its own order;
    # one rounding of the exact total matches it, or lands one float32
    # ulp away (SP1's server stage at B=50 and B=100)
    return float(np.float32(flops))


class StageCostModel:
    """FLOPs of the two stages and the smashed bytes for one (model, sp,
    batch shape) — the reference's ``StageCostModel.costs`` numbers,
    without compiling anything."""

    def costs(self, model, dev: Params, srv: Params, batch: Params,
              sp: int) -> Tuple[float, float, int]:
        if not isinstance(model, VGG5):
            raise NotImplementedError("only VGG-5 is ported")
        B, h, w, c = (int(d) for d in batch["images"].shape)
        per_layer = []
        out_elems = h * w * c
        for i, (kind, spec) in enumerate(model.layer_specs):
            last = i == model.num_layers - 1
            per_layer.append(_layer_flops(kind, spec, h, w, last))
            if kind == "conv":
                if spec[2]:
                    h, w = h // 2, w // 2
                out_elems = h * w * spec[1]
            else:
                out_elems = spec[1]
            if i == sp - 1:
                smashed = out_elems
        dev_f = B * sum(per_layer[:sp])
        srv_f = B * sum(per_layer[sp:]) + _loss_batch_terms(B)
        return _xla_sum(dev_f), _xla_sum(srv_f), B * smashed * 4


def batch_time_s(dev_profile: HardwareProfile, edge_profile: HardwareProfile,
                 link: LinkModel, dev_fwd_flops: float, srv_fwd_flops: float,
                 smashed_nbytes: int) -> float:
    """Simulated time of one split training batch (fwd+bwd ≈ 3× fwd)."""
    t_dev = 3.0 * dev_fwd_flops / dev_profile.flops_per_s
    t_srv = 3.0 * srv_fwd_flops / edge_profile.flops_per_s
    t_link = link.transfer_time(smashed_nbytes) * 2  # smashed up, grads down
    return t_dev + t_srv + t_link


def make_testbed_devices(batchers: List[Batcher],
                         edges: Tuple[str, str] = ("edge-A", "edge-B")
                         ) -> List[Device]:
    """The paper's four devices: Pi3_1, Pi3_2, Pi4_1, Pi4_2 — split across
    two edge servers."""
    profiles = [PI3, PI3, PI4, PI4]
    names = ["pi3_1", "pi3_2", "pi4_1", "pi4_2"]
    return [Device(n, p, b, edges[i % len(edges)])
            for i, (n, p, b) in enumerate(zip(names, profiles, batchers))]


def make_testbed_edges() -> List[EdgeServer]:
    return [EdgeServer("edge-A", EDGE_I5), EdgeServer("edge-B", EDGE_I7)]
