"""``BaseVersionRegistry``: the in-memory side of the delta migration
codec (a copy of ``repro.runtime.checkpoint_manager``'s). It tracks which
base version every edge server has synced (the round broadcast each edge
already receives), so a migration to an edge that holds round-k weights
ships only int8 residuals against that base and the destination decodes
with its own copy. The disk ``CheckpointManager`` is not ported yet."""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, Optional, Tuple


class BaseVersionRegistry:
    """Per-edge synced base versions for delta-encoded migrations.

    ``publish`` registers a new base tree under a version id;
    ``mark_synced`` records that an edge received it. ``base_for(edge)``
    returns the newest base that edge holds. Old bases are dropped LRU
    beyond ``keep`` (an edge whose synced version fell off receives a
    zero-base payload: still int8-compressed, never wrong)."""

    def __init__(self, keep: int = 4):
        self.keep = keep
        self._bases: "OrderedDict[str, Any]" = OrderedDict()
        self._synced: Dict[str, str] = {}

    def publish(self, version: str, tree: Any) -> str:
        self._bases[version] = tree
        self._bases.move_to_end(version)
        while len(self._bases) > self.keep:
            self._bases.popitem(last=False)
        return version

    def mark_synced(self, edge_id: str, version: str) -> None:
        self._synced[edge_id] = version

    def mark_all_synced(self, edge_ids, version: str) -> None:
        for e in edge_ids:
            self._synced[e] = version

    def synced_version(self, edge_id: str) -> Optional[str]:
        return self._synced.get(edge_id)

    def base(self, version: Optional[str]) -> Optional[Any]:
        return self._bases.get(version) if version is not None else None

    def base_for(self, edge_id: str) -> Tuple[Optional[Any], Optional[str]]:
        """(base tree, version) the edge can decode against, or
        (None, None) when it never synced / the base was dropped."""
        v = self._synced.get(edge_id)
        tree = self.base(v)
        return (tree, v) if tree is not None else (None, None)
