"""The FedFly migration checkpoint (paper §IV, "Model data checkpoint").

The source edge server checkpoints, per moving device: epoch number,
gradients, model weights, loss value, optimizer state, plus the round
number, batch index inside the epoch, split point and RNG seed, so the
destination resumes *the exact batch*.

The checkpoint carries its trees as it is given them, and the caller
hands them over in the **reference layout** (``repro.core.checkpoint``'s),
so a container packed by either package unpacks in the other. The VGG-5
scheduler converts its stage with ``models.vgg.params_to_reference``
before the move and back with ``params_from_reference`` after it; a
decode session (``core/serve_migration.py``) is in that layout already.
The tensors stay on their device until the serializer ships them, and
``unpack`` puts every leaf on the receiving device.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.runtime import serialization

Params = Any


def _as_bytes(leaf) -> bytes:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.cpu().numpy()
    return bytes(np.asarray(leaf, np.uint8))


@dataclass
class EdgeCheckpoint:
    """Everything the destination edge server needs to resume training of
    one device's server-side stage mid-round."""

    client_id: str
    round_idx: int
    epoch: int
    batch_idx: int
    split_point: int
    server_params: Params
    optimizer_state: Params
    last_grads: Optional[Params] = None     # paper lists gradients explicitly
    loss: float = 0.0
    rng_seed: int = 0
    meta: Dict[str, Any] = field(default_factory=dict)

    # -- serialization ------------------------------------------------------

    def to_tree(self) -> Dict[str, Any]:
        scalars = {
            "client_id": np.frombuffer(
                self.client_id.encode().ljust(64, b"\0")[:64], np.uint8).copy(),
            "round_idx": np.int64(self.round_idx),
            "epoch": np.int64(self.epoch),
            "batch_idx": np.int64(self.batch_idx),
            "split_point": np.int64(self.split_point),
            "loss": np.float64(self.loss),
            "rng_seed": np.int64(self.rng_seed),
        }
        tree: Dict[str, Any] = {
            "scalars": scalars,
            "server_params": self.server_params,
            "optimizer_state": self.optimizer_state,
        }
        if self.last_grads is not None:
            tree["last_grads"] = self.last_grads
        return tree

    @classmethod
    def from_tree(cls, tree: Dict[str, Any]) -> "EdgeCheckpoint":
        s = tree["scalars"]
        return cls(
            client_id=_as_bytes(s["client_id"]).rstrip(b"\0").decode(),
            round_idx=int(s["round_idx"]),
            epoch=int(s["epoch"]),
            batch_idx=int(s["batch_idx"]),
            split_point=int(s["split_point"]),
            server_params=tree["server_params"],
            optimizer_state=tree["optimizer_state"],
            last_grads=tree.get("last_grads"),
            loss=float(s["loss"]),
            rng_seed=int(s["rng_seed"]),
        )

    def pack(self, codec: str = "raw", *, base=None,
             base_version: Optional[str] = None, device="cuda") -> bytes:
        """``base`` is a (possibly partial) tree mirroring ``to_tree()``
        — e.g. ``{"server_params": <round-start stage>}`` in the
        reference layout — that the delta codec encodes residuals
        against."""
        return serialization.pack_pytree(self.to_tree(), codec=codec,
                                         base=base,
                                         base_version=base_version,
                                         device=device)

    def pack_chunks(self, codec: str = "raw", *, base=None,
                    base_version: Optional[str] = None, device="cuda"):
        """Incremental serialization for streamed transfers."""
        return serialization.pack_pytree_chunks(
            self.to_tree(), codec=codec, base=base,
            base_version=base_version, device=device)

    @classmethod
    def unpack(cls, data: bytes, *, base=None, device="cuda"
               ) -> "EdgeCheckpoint":
        return cls.from_tree(
            serialization.unpack_pytree(data, base=base, device=device))

    def nbytes(self, codec: str = "raw", **kw) -> int:
        return len(self.pack(codec, **kw))
