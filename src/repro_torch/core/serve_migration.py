"""Serving-session migration: FedFly's mechanism applied to inference.

The torch counterpart of ``repro.core.serve_migration``. When a device
moves mid-generation, the source edge checkpoints its decode session
(``{KV cache / recurrent state, position, tokens generated}``) and the
destination resumes decoding the next token bit-identically (raw codec).

``ServeSession.to_tree`` is the reference's tree: the same scalars as
numpy values and the cache leaves (tensors, in the reference's layout),
so a session's FFLY container is byte-identical to the reference's for
the same cache. ``migrate_session`` ships the session through the port's
``MigrationExecutor`` as the ``server_params`` of an ``EdgeCheckpoint``,
which carries its trees as it is given them.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict

import numpy as np

from repro_torch.core.checkpoint import EdgeCheckpoint, _as_bytes
from repro_torch.runtime import serialization

Params = Any


@dataclass
class ServeSession:
    """One device's decode session held by an edge server."""

    session_id: str
    cache: Params                 # model.init_cache tree (KV / states)
    position: int                 # next decode position
    tokens_generated: int = 0
    meta: Dict[str, Any] = field(default_factory=dict)

    def to_tree(self) -> Dict[str, Any]:
        return {
            "scalars": {
                "session_id": np.frombuffer(
                    self.session_id.encode().ljust(64, b"\0")[:64],
                    np.uint8).copy(),
                "position": np.int64(self.position),
                "tokens_generated": np.int64(self.tokens_generated),
            },
            "cache": self.cache,
        }

    @classmethod
    def from_tree(cls, tree: Dict[str, Any]) -> "ServeSession":
        """Scalars come back as Python values, the cache as it was
        unpacked (tensors on the receiving device)."""
        s = tree["scalars"]
        return cls(
            session_id=_as_bytes(s["session_id"]).rstrip(b"\0").decode(),
            cache=tree["cache"],
            position=int(s["position"]),
            tokens_generated=int(s["tokens_generated"]))

    def pack(self, codec: str = "raw", *, device="cuda") -> bytes:
        return serialization.pack_pytree(self.to_tree(), codec=codec,
                                         device=device)

    @classmethod
    def unpack(cls, data: bytes, *, device="cuda") -> "ServeSession":
        return cls.from_tree(serialization.unpack_pytree(data,
                                                         device=device))

    def nbytes(self, codec: str = "raw", *, device="cuda") -> int:
        return len(self.pack(codec, device=device))


def migrate_session(session: ServeSession, executor, src_edge: str,
                    dst_edge: str, route: str = "direct"):
    """Move a decode session between edges through the migration
    executor (its link model, codec and reporting). Returns the restored
    session (cache on the executor's device) and the report."""
    ck = EdgeCheckpoint(
        client_id=session.session_id, round_idx=0, epoch=0,
        batch_idx=session.position, split_point=0,
        server_params=session.to_tree(), optimizer_state={},
        meta={"kind": "serve_session"})
    restored, report = executor.migrate(ck, src_edge, dst_edge, route=route)
    return ServeSession.from_tree(restored.server_params), report
