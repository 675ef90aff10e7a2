"""Wrappers of the packed int8 codec kernels (``csrc/int8_codec.cu``).

``quantize_packed`` / ``dequantize_packed`` take one flat float32
buffer — every quantized leaf of a checkpoint, at BLOCK-aligned offsets
(``ops.quantize_leaves``) — so a whole migration payload is one launch.
A ``base`` buffer switches both to residual mode (the delta codec).

Dispatch: ``use_kernel=None`` launches the CUDA kernel for a CUDA tensor
and runs the plain torch version (``ref.py``) for a CPU tensor;
``use_kernel=False`` runs the plain version on either device (the card
compares the two); ``use_kernel=True`` on a CPU tensor raises. A build or
launch failure raises — nothing falls back to the plain version.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import native
from repro_torch.kernels.int8_codec.ref import (BLOCK, dequantize_packed_ref,
                                                quantize_packed_ref)

__all__ = ["BLOCK", "quantize_packed", "dequantize_packed"]

_P = ctypes.c_void_p
_QUANT_ARGS = [_P, _P, ctypes.c_longlong, _P, _P, _P]
_DEQUANT_ARGS = [_P, _P, ctypes.c_longlong, _P, ctypes.c_longlong, _P, _P]


def _check_flat(t: torch.Tensor, dtype: torch.dtype, n: int, what: str):
    if (t.dtype != dtype or t.dim() != 1 or t.numel() < n
            or not t.is_contiguous() or not t.is_cuda):
        raise ValueError(f"{what}: need a contiguous 1-D CUDA {dtype} "
                         f"tensor of >= {n} values, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def quantize_packed(x: torch.Tensor, base: Optional[torch.Tensor] = None, *,
                    use_kernel: Optional[bool] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x, base: (n,) float32 -> (q (R*BLOCK,) int8, scales (R,) f32) with
    R = ceil(n / BLOCK); residual ``x - base`` when ``base`` is given."""
    if not native.use_kernel_for(x, use_kernel):
        return quantize_packed_ref(x, base)
    n = x.numel()
    _check_flat(x, torch.float32, n, "quantize_packed x")
    if base is not None:
        _check_flat(base, torch.float32, n, "quantize_packed base")
    rows = -(-n // BLOCK)
    q = torch.empty(rows * BLOCK, dtype=torch.int8, device=x.device)
    scales = torch.empty(rows, dtype=torch.float32, device=x.device)
    if n:
        launch_quantize(x, base, q, scales)
    return q, scales


def launch_quantize(x: torch.Tensor, base: Optional[torch.Tensor],
                    q: torch.Tensor, scales: torch.Tensor) -> None:
    """Launch the quantize kernel on checked, allocated buffers (x and
    base: n float32; q: ceil(n/BLOCK)*BLOCK int8; scales: ceil(n/BLOCK)
    float32) on the current stream."""
    fn = native.function("int8_codec", "ffly_quantize_packed", _QUANT_ARGS)
    with torch.cuda.device(x.device):
        rc = fn(native.ptr(x), native.ptr(base), x.numel(), native.ptr(q),
                native.ptr(scales), native.stream(x))
    native.check(rc, "quantize_packed")
    native.count_launch("quantize_packed")


def dequantize_packed(q: torch.Tensor, scales: torch.Tensor, n: int,
                      base: Optional[torch.Tensor] = None,
                      dtype: torch.dtype = torch.float32, *,
                      use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Inverse of ``quantize_packed`` -> (n,) ``dtype`` (decoded in
    float32, then cast). Accepts trimmed ``q`` (>= n values) and trimmed
    ``scales``; rows without a scale decode with 1.0."""
    if not native.use_kernel_for(q, use_kernel):
        return dequantize_packed_ref(q, scales, n, base, dtype)
    _check_flat(q, torch.int8, n, "dequantize_packed q")
    _check_flat(scales, torch.float32, 0, "dequantize_packed scales")
    if base is not None:
        _check_flat(base, torch.float32, n, "dequantize_packed base")
    out = torch.empty(n, dtype=torch.float32, device=q.device)
    if n:
        launch_dequantize(q, scales, base, out)
    return out.to(dtype)


def launch_dequantize(q: torch.Tensor, scales: torch.Tensor,
                      base: Optional[torch.Tensor], out: torch.Tensor) -> None:
    """Launch the dequantize kernel on checked, allocated buffers: decodes
    ``out.numel()`` values on the current stream."""
    fn = native.function("int8_codec", "ffly_dequantize_packed",
                         _DEQUANT_ARGS)
    with torch.cuda.device(q.device):
        rc = fn(native.ptr(q), native.ptr(scales), scales.numel(),
                native.ptr(base), out.numel(), native.ptr(out),
                native.stream(q))
    native.check(rc, "dequantize_packed")
    native.count_launch("dequantize_packed")
