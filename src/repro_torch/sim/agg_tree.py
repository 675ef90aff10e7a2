"""Floating-root placement for two-level (hierarchical) aggregation.

With ``agg_tree="2level"`` each shard group folds its own cohorts'
updates into one fixed-point partial and ships it to the round's *root
aggregator* — an edge chosen per round, not a fixed coordinator (the
"optimized floating aggregation point" of the multi-edge FL literature;
FedFly's mobile devices make the best root drift as the fleet moves).

The placement is a pure function of simulated state, so every executor
(serial, pipes, sockets) computes the same root for the same round:

    root = argmin_e  sum_g  partial_bytes_g * cost(home_g -> e)

over the home edges of the *live* groups, where ``home_g`` is the
lexicographically-lowest edge a group's shards own, ``partial_bytes_g``
is the size of the group's int64 accumulator (0 for a group with no
updates this window — those ship nothing), and ``cost`` prices one
backhaul traversal from the simulated link models (latency + bytes /
bandwidth; a group already at the candidate edge pays nothing). Ties
break on the lexicographically-lowest edge id.

Placement never touches the numerics or the event timeline — a root
move is *priced* through the real delta-migration pipeline and reported
(``agg.root_move_bytes``), keeping timing metrics bit-identical with
and without re-placement. Recovery composes: a rebuilt mesh has a new
owner map, so the next commit re-places the root over the surviving
groups' homes (ARCHITECTURE §3.8).

A copy of ``repro.sim.agg_tree``. It reads no clock and no global state:
the same inputs place the same root in every process.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, Mapping, Tuple

__all__ = ["group_homes", "link_cost", "place_root"]


def group_homes(owner_of_shard: Mapping[int, int],
                edges_of_shard: Mapping[int, Iterable[str]]
                ) -> Dict[int, str]:
    """Home edge per group: the lexicographically-lowest edge id owned
    by any of the group's shards — stable under shard re-assignment as
    long as the group keeps that edge."""
    homes: Dict[int, str] = {}
    for sid in sorted(owner_of_shard):
        g = owner_of_shard[sid]
        for e in edges_of_shard.get(sid, ()):
            if g not in homes or e < homes[g]:
                homes[g] = e
    return homes


def link_cost(links: Mapping[str, Any], src: str, dst: str,
              nbytes: float) -> float:
    """One simulated backhaul traversal src -> dst for ``nbytes``:
    latency + serialization on the source edge's backhaul link. Zero
    when src == dst (the partial is already at the root)."""
    if src == dst:
        return 0.0
    link = links[src]
    return float(link.latency_s) + (8.0 * float(nbytes)
                                    / float(link.bandwidth_bps))


def place_root(homes: Mapping[int, str],
               bytes_by_group: Mapping[int, float],
               links: Mapping[str, Any]) -> Tuple[str, float]:
    """Score every live group's home edge as a root candidate and
    return (edge_id, total transfer cost). Deterministic: candidates
    and contributing groups are iterated in sorted order, ties go to
    the lexicographically-lowest edge id."""
    if not homes:
        raise ValueError("place_root needs at least one live group")
    candidates = sorted(set(homes.values()))
    best: Tuple[str, float] = ("", float("inf"))
    for e in candidates:
        score = 0.0
        for g in sorted(homes):
            b = float(bytes_by_group.get(g, 0.0))
            if b > 0.0:
                score += link_cost(links, homes[g], e, b)
        if score < best[1]:
            best = (e, score)
    return best
