"""Mobility traces: when which device moves between which edge servers
(a copy of the parts of ``repro.core.mobility`` the testbed uses).

``fraction`` ∈ [0, 1) is the position *inside the round's local epoch* at
which the device disconnects (the paper's "after 50%/90% of the training
is completed" maps to fraction=0.5/0.9 of the device's batches).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence


@dataclass(frozen=True)
class MoveEvent:
    round_idx: int          # FL round during which the move happens
    client_id: str
    src_edge: str
    dst_edge: str
    fraction: float = 0.0   # progress through the round's batches at move


def move_at_round(client_id: str, src: str, dst: str, round_idx: int,
                  fraction: float = 0.0) -> List[MoveEvent]:
    return [MoveEvent(round_idx, client_id, src, dst, fraction)]


class MobilityTrace:
    """Indexable trace; the scheduler polls it once per (round, client)."""

    def __init__(self, events: Sequence[MoveEvent]):
        self._by_round = {}
        for e in events:
            self._by_round.setdefault(e.round_idx, []).append(e)
        self.events = list(events)

    def move_for(self, round_idx: int, client_id: str) -> Optional[MoveEvent]:
        for e in self._by_round.get(round_idx, []):
            if e.client_id == client_id:
                return e
        return None
