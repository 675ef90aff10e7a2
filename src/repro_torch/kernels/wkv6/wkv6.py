"""Wrapper of the WKV6 recurrence kernel (``csrc/wkv6.cu``).

``wkv6(r, k, v, w, u, state0=None)`` takes the reference kernel's
layout — r/k/v/w (B, T, H, 64), u (H, 64) — in float32 or bfloat16, and
returns (y (B, T, H, 64) in r's dtype, final state (B, H, 64, 64)
float32). Any T works: the kernel walks the sequence itself, so there is
no chunk-divisibility limit and no fallback (``repro``'s
``wkv6/ops.py:14``). ``state0`` (float32) starts the recurrence from a
carried state; None starts from zero, as ``wkv6_chunked`` does.

Dispatch as in ``int8_codec``: ``use_kernel=None`` launches the kernel
for a CUDA tensor and runs the plain version (``ref.py``) for a CPU
tensor; ``use_kernel=False`` runs the plain version on either device;
``use_kernel=True`` on a CPU tensor raises. A build or launch failure
raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import native
from repro_torch.kernels.wkv6.ref import wkv6_ref

HEAD = 64
_DTYPES = (torch.float32, torch.bfloat16)

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         w: torch.Tensor, u: torch.Tensor,
         state0: Optional[torch.Tensor] = None, *,
         use_kernel: Optional[bool] = None
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    if not native.use_kernel_for(r, use_kernel):
        return wkv6_ref(r, k, v, w, u, state0)
    B, T, H, K = r.shape
    if K != HEAD or r.dtype not in _DTYPES:
        raise ValueError(f"wkv6: the kernel takes (B, T, H, {HEAD}) "
                         f"float32/bfloat16 inputs, got {r.dtype} "
                         f"{tuple(r.shape)}")
    for name, t in (("k", k), ("v", v), ("w", w)):
        if t.shape != r.shape or t.dtype != r.dtype or t.device != r.device:
            raise ValueError(f"wkv6: {name} {t.dtype} {tuple(t.shape)} on "
                             f"{t.device} does not match r")
    if u.shape != (H, K):
        raise ValueError(f"wkv6: u must be ({H}, {K}), got {tuple(u.shape)}")
    if state0 is not None and state0.shape != (B, H, K, K):
        raise ValueError(f"wkv6: state0 must be ({B}, {H}, {K}, {K}), got "
                         f"{tuple(state0.shape)}")
    dev = r.device
    r, k, v, w = (t.contiguous() for t in (r, k, v, w))
    u = u.to(device=dev, dtype=torch.float32).contiguous()
    if state0 is not None:
        state0 = state0.to(device=dev, dtype=torch.float32).contiguous()
    y = torch.empty_like(r)
    state = torch.empty((B, H, K, K), dtype=torch.float32, device=dev)
    launch_wkv6(r, k, v, w, u, state0, y, state)
    return y, state


def launch_wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                w: torch.Tensor, u: torch.Tensor,
                state0: Optional[torch.Tensor], y: torch.Tensor,
                state: torch.Tensor) -> None:
    """Launch the kernel on checked contiguous buffers on the current
    stream."""
    B, T, H, _ = r.shape
    fn = native.function("wkv6", "ffly_wkv6", _ARGS)
    with torch.cuda.device(r.device):
        rc = fn(native.ptr(r), native.ptr(k), native.ptr(v), native.ptr(w),
                native.ptr(u), native.ptr(state0), native.ptr(y),
                native.ptr(state), B, T, H, int(r.dtype == torch.bfloat16),
                native.stream(r))
    native.check(rc, "wkv6")
    native.count_launch("wkv6")
