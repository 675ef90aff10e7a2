"""Multi-leaf helpers for migration payloads (``repro``'s
``kernels/int8_codec/ops.py``).

``quantize_leaves`` is the migration hot path: it packs every float leaf
of a checkpoint into ONE flat float32 buffer on the device (each leaf at
a BLOCK-aligned offset, zero padding between) and quantizes the whole
payload in a single launch. ``base_leaves`` (an aligned list, ``None``
entries allowed) switches to residual mode against a base buffer built
the same way; a ``None`` entry is a zero base for that leaf, i.e. plain
blockwise int8 of its value. The leaves never leave the device: only
``q`` and the scales come back, when the caller copies them.

Offsets depend on leaf sizes alone, so a container header can be planned
before the buffer exists (``leaf_offsets``).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.int8_codec.int8_codec import (BLOCK,
                                                       dequantize_packed,
                                                       quantize_packed)


def num_scales(n: int, block: int = BLOCK) -> int:
    return -(-n // block)


def _aligned(n: int, block: int = BLOCK) -> int:
    return -(-n // block) * block


def _size(x) -> int:
    return x.numel() if isinstance(x, torch.Tensor) else int(np.size(x))


def _as_f32(x, device) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    return t.to(device=device, dtype=torch.float32).reshape(-1)


def leaf_offsets(leaves: Sequence) -> np.ndarray:
    """BLOCK-aligned start offsets ((len+1,) int64) of each leaf in the
    packed flat buffer, from sizes alone."""
    starts = np.zeros(len(leaves) + 1, np.int64)
    for i, x in enumerate(leaves):
        starts[i + 1] = starts[i] + _aligned(_size(x))
    return starts


def pack_leaves(leaves: Sequence, device, offsets: Optional[np.ndarray] = None
                ) -> Tuple[torch.Tensor, np.ndarray]:
    """Leaves -> (flat (n_pad,) float32 on ``device``, offsets). ``None``
    leaves stay zero (a zero base)."""
    starts = leaf_offsets(leaves) if offsets is None else offsets
    flat = torch.zeros(int(starts[-1]), dtype=torch.float32, device=device)
    for i, x in enumerate(leaves):
        if x is not None:
            arr = _as_f32(x, device)
            flat[int(starts[i]):int(starts[i]) + arr.numel()] = arr
    return flat, starts


def quantize_leaves(leaves: Sequence,
                    base_leaves: Optional[Sequence] = None, *,
                    device, use_kernel: Optional[bool] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, np.ndarray]:
    """All float leaves -> ONE quantize launch on ``device``.

    Returns (q (n,) int8, scales (ceil(n/BLOCK),) f32, offsets), both
    tensors on ``device``. With ``base_leaves`` the residuals are
    quantized."""
    flat, offsets = pack_leaves(leaves, device)
    n = flat.numel()
    base_flat = None
    if base_leaves is not None:
        base_flat, _ = pack_leaves(base_leaves, device, offsets)
    q, s = quantize_packed(flat, base_flat, use_kernel=use_kernel)
    return q[:n], s[:num_scales(n)], offsets


def dequantize_leaves(q, scales, offsets: np.ndarray,
                      shapes: Sequence[Tuple[int, ...]],
                      dtypes: Sequence[torch.dtype],
                      base_leaves: Optional[Sequence] = None, *,
                      device, use_kernel: Optional[bool] = None
                      ) -> List[torch.Tensor]:
    """Inverse of ``quantize_leaves``: one launch, then a view per leaf by
    the offset table, cast to its dtype. ``q``/``scales`` may be host
    arrays (the container's sections); they are copied to ``device``."""
    n = int(offsets[-1])
    q_t = _to_device(q, device)
    s_t = _to_device(scales, device)
    base_flat = None
    if base_leaves is not None:
        base_flat, _ = pack_leaves(base_leaves, device, offsets)
    flat = dequantize_packed(q_t, s_t, n, base_flat, use_kernel=use_kernel)
    out = []
    for i, (shp, dt) in enumerate(zip(shapes, dtypes)):
        size = int(np.prod(shp)) if shp else 1
        out.append(flat[int(offsets[i]):int(offsets[i]) + size]
                   .to(dt).reshape(shp))
    return out


def _to_device(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.array(x, copy=True)).to(device)
