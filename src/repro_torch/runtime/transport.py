"""Link timing for edge-to-edge migration traffic.

``LinkModel`` is the analytic timing of one link (the testbed's 75 Mbps
Wi-Fi), used by the simulated clock; a copy of ``repro``'s. The socket
transports are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class LinkModel:
    bandwidth_bps: float = 75e6   # paper: 75 Mbps Wi-Fi
    latency_s: float = 0.005

    def transfer_time(self, nbytes: int) -> float:
        return self.latency_s + 8.0 * nbytes / self.bandwidth_bps
