"""Wrappers of the FedAvg aggregation kernels (``csrc/fedavg_agg.cu``).

``fedavg_agg(stacked, weights)`` is ``normalize(weights) @ stacked`` for
``stacked (E, N)`` float32: one launch streams all E client vectors once.
The weights are normalized on the host, as in the reference.

``fedavg_agg_mix(global_flat, stacked, weights)`` is ``(1 - sum(w)) *
global_flat + w @ stacked`` with unnormalized effective coefficients: one
launch folds a FedAsync flush window into the global vector. ``keep`` is
computed on the host (``ref.mix_coeffs``).

Dispatch as in ``int8_codec``: ``use_kernel=None`` launches the kernel
for a CUDA tensor and runs the plain version for a CPU tensor; a build
or launch failure raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import native
from repro_torch.kernels.fedavg_agg.ref import (fedavg_agg_mix_ref,
                                                fedavg_agg_ref, mix_coeffs,
                                                normalize_weights)

_P = ctypes.c_void_p
_AGG_ARGS = [_P, _P, ctypes.c_int, ctypes.c_longlong, _P, _P]
_MIX_ARGS = [_P, _P, _P, ctypes.c_float, ctypes.c_int, ctypes.c_longlong,
             _P, _P]


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


def fedavg_agg_mix(global_flat: torch.Tensor, stacked: torch.Tensor,
                   weights, *, use_kernel: Optional[bool] = None
                   ) -> torch.Tensor:
    """global_flat: (N,) float; stacked: (E, N) float32; weights: (E,)
    effective mixing coefficients (not normalized: their sum is the mass
    moved off the old global). Returns (N,) in global_flat's dtype; the
    arithmetic is float32."""
    if not native.use_kernel_for(stacked, use_kernel):
        return fedavg_agg_mix_ref(global_flat, stacked, weights)
    if (stacked.dtype != torch.float32 or stacked.dim() != 2
            or not stacked.is_contiguous()):
        raise ValueError("fedavg_agg_mix: the kernel takes a contiguous "
                         f"(E, N) float32 tensor, got {stacked.dtype} "
                         f"{tuple(stacked.shape)}")
    E, N = stacked.shape
    if (global_flat.shape != (N,) or not global_flat.is_floating_point()
            or global_flat.device != stacked.device):
        raise ValueError(f"fedavg_agg_mix: global {global_flat.dtype} "
                         f"{tuple(global_flat.shape)} on "
                         f"{global_flat.device} for {N} columns on "
                         f"{stacked.device}")
    w, keep = mix_coeffs(weights)
    if w.size != E:
        raise ValueError(f"fedavg_agg_mix: {w.size} weights for {E} rows")
    g = global_flat.to(torch.float32).contiguous()
    out = torch.empty(N, dtype=torch.float32, device=stacked.device)
    if N:
        launch_fedavg_agg_mix(g, stacked, torch.from_numpy(w).to(
            stacked.device), keep, out)
    return out.to(global_flat.dtype)


def launch_fedavg_agg_mix(g: torch.Tensor, stacked: torch.Tensor,
                          w: torch.Tensor, keep: float,
                          out: torch.Tensor) -> None:
    """Launch the mix kernel on checked buffers: ``g`` (N,) float32,
    ``stacked`` (E, N) float32, ``w`` (E,) float32 on the card, ``keep``
    the host's ``1 - sum(w)``, ``out`` (N,) float32."""
    E, N = stacked.shape
    fn = native.function("fedavg_agg", "ffly_fedavg_agg_mix", _MIX_ARGS)
    with torch.cuda.device(stacked.device):
        rc = fn(native.ptr(g), native.ptr(stacked), native.ptr(w),
                float(keep), E, N, native.ptr(out), native.stream(stacked))
    native.check(rc, "fedavg_agg_mix")
    native.count_launch("fedavg_agg_mix")
