"""Plain versions of the packed int8 codec.

Per BLOCK-element row: ``s = max(max|r| / 127, 1e-12)``,
``q = clip(rint(r / s), -127, 127)`` with ``r = x`` or ``r = x - base``
(residual mode); decode is ``q * s (+ base)``.

Two flavours:

  ``quantize_packed_ref``/``dequantize_packed_ref`` — torch, the plain
        version of the CUDA kernels: the CPU path runs it, and the card
        compares the kernels with it. Every division is tensor by tensor
        (a CUDA division by a Python scalar becomes a multiply by the
        reciprocal, which rounds differently).
  ``quantize_packed_np``/``dequantize_packed_np`` — numpy, a copy of
        ``repro.kernels.int8_codec.ref``'s ``quantize_packed_ref``/
        ``dequantize_packed_ref``: the exactness oracle the kernels and
        the torch version are held to without importing the reference.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

BLOCK = 1024


def _rows(n: int, block: int = BLOCK) -> int:
    return -(-n // block)


def quantize_packed_ref(x: torch.Tensor, base: Optional[torch.Tensor] = None,
                        block: int = BLOCK
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (n,) float -> (q (R*block,) int8, scales (R,) f32), R =
    ceil(n/block); the padded tail quantizes to 0."""
    n = x.numel()
    if n == 0:
        return (torch.zeros(0, dtype=torch.int8, device=x.device),
                torch.zeros(0, dtype=torch.float32, device=x.device))
    R = _rows(n, block)
    r = x.reshape(-1).float()
    if base is not None:
        r = r - base.reshape(-1).float()
    r = F.pad(r, (0, R * block - n)).reshape(R, block)
    amax = r.abs().amax(dim=1)
    s = torch.clamp_min(amax / torch.full_like(amax, 127.0), 1e-12)
    q = torch.clamp(torch.round(r / s[:, None]), -127, 127)
    return q.to(torch.int8).reshape(-1), s


def dequantize_packed_ref(q: torch.Tensor, scales: torch.Tensor, n: int,
                          base: Optional[torch.Tensor] = None,
                          dtype=torch.float32, block: int = BLOCK
                          ) -> torch.Tensor:
    """Inverse of ``quantize_packed_ref`` on the first ``n`` values.
    Accepts a trimmed ``q`` (>= n values) and trimmed ``scales``; rows
    without a scale decode with 1.0."""
    if n == 0:
        return torch.zeros(0, dtype=dtype, device=q.device)
    R = _rows(n, block)
    s = torch.ones(R, dtype=torch.float32, device=q.device)
    k = min(R, scales.numel())
    s[:k] = scales.reshape(-1)[:k].float()
    qf = F.pad(q.reshape(-1)[:n].float(), (0, R * block - n)).reshape(R, block)
    x = (qf * s[:, None]).reshape(-1)[:n]
    if base is not None:
        x = x + base.reshape(-1)[:n].float()
    return x.to(dtype)


# -- numpy oracle (copy of the reference's CPU path) -------------------------

_SLAB_ROWS = 128


def quantize_packed_np(x: np.ndarray, base: Optional[np.ndarray] = None,
                       block: int = BLOCK) -> Tuple[np.ndarray, np.ndarray]:
    """x (n,) float -> (q (n,) int8, scales (ceil(n/block),) f32)."""
    n = x.shape[0]
    R = -(-n // block)
    q = np.empty(R * block, np.int8)
    scales = np.empty(R, np.float32)
    if n == 0:
        return q, scales
    xf = np.asarray(x)
    bf = np.asarray(base) if base is not None else None
    buf = np.empty((min(_SLAB_ROWS, R), block), np.float32)
    for r0 in range(0, R, _SLAB_ROWS):
        r1 = min(r0 + _SLAB_ROWS, R)
        lo, hi = r0 * block, min(r1 * block, n)
        xs = buf[:r1 - r0]
        fl = xs.reshape(-1)
        fl[:hi - lo] = xf[lo:hi]
        if bf is not None:
            fl[:hi - lo] -= np.asarray(bf[lo:hi], np.float32)
        fl[hi - lo:] = 0.0
        s = np.abs(xs).max(axis=1)
        s /= 127.0
        np.maximum(s, 1e-12, out=s)
        np.divide(xs, s[:, None], out=xs)
        np.rint(xs, out=xs)
        np.clip(xs, -127, 127, out=xs)
        q[lo:r1 * block] = fl
        scales[r0:r1] = s
    return q[:n], scales


def dequantize_packed_np(q: np.ndarray, scales: np.ndarray, n: int,
                         base: Optional[np.ndarray] = None,
                         block: int = BLOCK) -> np.ndarray:
    """Decode to float32 (n,); needs all ceil(n/block) scales."""
    out = np.empty(n, np.float32)
    if n == 0:
        return out
    R = -(-n // block)
    sc = np.asarray(scales, np.float32)
    buf = np.empty((min(_SLAB_ROWS, R), block), np.float32)
    for r0 in range(0, R, _SLAB_ROWS):
        r1 = min(r0 + _SLAB_ROWS, R)
        lo, hi = r0 * block, min(r1 * block, n)
        xs = buf[:r1 - r0]
        fl = xs.reshape(-1)
        fl[:hi - lo] = q[lo:hi]
        fl[hi - lo:] = 0.0
        np.multiply(xs, sc[r0:r1, None], out=xs)
        if base is not None:
            fl[:hi - lo] += np.asarray(base[lo:hi], np.float32)
        out[lo:hi] = fl[:hi - lo]
    return out
