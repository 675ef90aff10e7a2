"""Wrapper of the FedAvg aggregation kernel (``csrc/fedavg_agg.cu``).

``fedavg_agg(stacked, weights)`` is ``normalize(weights) @ stacked`` for
``stacked (E, N)`` float32: one launch streams all E client vectors once.
The weights are normalized on the host, as in the reference.

Dispatch as in ``int8_codec``: ``use_kernel=None`` launches the kernel
for a CUDA tensor and runs the plain version for a CPU tensor; a build
or launch failure raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import native
from repro_torch.kernels.fedavg_agg.ref import (fedavg_agg_ref,
                                                normalize_weights)

_P = ctypes.c_void_p
_AGG_ARGS = [_P, _P, ctypes.c_int, ctypes.c_longlong, _P, _P]


def fedavg_agg(stacked: torch.Tensor, weights, *,
               use_kernel: Optional[bool] = None) -> torch.Tensor:
    """stacked: (E, N) float32; weights: (E,) unnormalized -> (N,)."""
    if not native.use_kernel_for(stacked, use_kernel):
        return fedavg_agg_ref(stacked, weights)
    if (stacked.dtype != torch.float32 or stacked.dim() != 2
            or not stacked.is_contiguous()):
        raise ValueError("fedavg_agg: the kernel takes a contiguous (E, N) "
                         f"float32 tensor, got {stacked.dtype} "
                         f"{tuple(stacked.shape)}")
    E, N = stacked.shape
    w = normalize_weights(weights)
    if w.numel() != E:
        raise ValueError(f"fedavg_agg: {w.numel()} weights for {E} rows")
    w = w.to(stacked.device)
    out = torch.empty(N, dtype=torch.float32, device=stacked.device)
    if N:
        launch_fedavg_agg(stacked, w, out)
    return out


def launch_fedavg_agg(stacked: torch.Tensor, w: torch.Tensor,
                      out: torch.Tensor) -> None:
    """Launch the kernel on checked buffers: ``stacked`` (E, N) float32,
    normalized ``w`` (E,) float32 on the card, ``out`` (N,) float32."""
    E, N = stacked.shape
    fn = native.function("fedavg_agg", "ffly_fedavg_agg", _AGG_ARGS)
    with torch.cuda.device(stacked.device):
        rc = fn(native.ptr(stacked), native.ptr(w), E, N, native.ptr(out),
                native.stream(stacked))
    native.check(rc, "fedavg_agg")
    native.count_launch("fedavg_agg")
