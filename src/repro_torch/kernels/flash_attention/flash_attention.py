"""Wrapper of the flash-attention forward kernels: float32 on the SIMT
kernel ``csrc/flash_attention.cu`` (launches counted as
``flash_attention``), bfloat16 on the tensor-core kernel
``csrc/flash_attention_mma.cu`` (counted as ``flash_attention_bf16``).

``flash_attention_fwd(q, k, v, *, causal, window, softcap)`` takes the
reference kernel's layout — q (B, H, S, hd), k/v (B, KV, T, hd) — in
float32 or bfloat16, with hd 64 or 128 on the card, and returns
(B, H, S, hd) in q's dtype. S and T need not be multiples of any block,
keys past T are never attended in any mode, and query head h reads KV
head h // (H // KV). The bf16 kernel copies 16 bytes a thread, so an
input whose first element is not 16-byte aligned (a view at an odd
offset) is copied first.

Dispatch as in ``int8_codec``: ``use_kernel=None`` launches the kernel
for a CUDA tensor and runs the plain version (``ref.py``) for a CPU
tensor; ``use_kernel=False`` runs the plain version on either device;
``use_kernel=True`` on a CPU tensor raises. A build or launch failure
raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import native
from repro_torch.kernels.flash_attention.ref import attention_ref

HEAD_DIMS = (64, 128)

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P]
# dtype -> (library, C function, launch counter)
_KERNELS = {torch.float32: ("flash_attention", "ffly_flash_attention_fwd",
                            "flash_attention"),
            torch.bfloat16: ("flash_attention_mma",
                             "ffly_flash_attention_bf16_fwd",
                             "flash_attention_bf16")}
_DTYPES = tuple(_KERNELS)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0,
                        use_kernel: Optional[bool] = None) -> torch.Tensor:
    if not native.use_kernel_for(q, use_kernel):
        return attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap)
    B, H, S, hd = q.shape
    KV, T = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: the kernel takes hd in "
                         f"{HEAD_DIMS}, got {hd}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash_attention: q, k, v must share one dtype of "
                         f"{_DTYPES}, got {q.dtype}, {k.dtype}, {v.dtype}")
    if (k.shape != (B, KV, T, hd) or v.shape != k.shape or KV == 0
            or H % KV):
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k/v "
                         f"{tuple(k.shape)}/{tuple(v.shape)} do not match")
    if not (k.is_cuda and v.is_cuda and k.device == q.device == v.device):
        raise ValueError("flash_attention: q, k, v must be on one CUDA "
                         "device")
    q, k, v = (aligned(t.contiguous()) for t in (q, k, v))
    out = torch.empty_like(q)
    launch_flash_attention(q, k, v, out, causal=causal, window=window,
                           softcap=softcap)
    return out


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself if its first element sits on a 16-byte boundary, else
    a copy of it (fresh storage is aligned)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def launch_flash_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, out: torch.Tensor, *,
                           causal: bool, window: int, softcap: float) -> None:
    """Launch the kernel of q's dtype on checked contiguous, 16-byte
    aligned buffers on the current stream."""
    B, H, S, hd = q.shape
    KV, T = k.shape[1], k.shape[2]
    lib, cfn, name = _KERNELS[q.dtype]
    fn = native.function(lib, cfn, _ARGS)
    with torch.cuda.device(q.device):
        rc = fn(native.ptr(q), native.ptr(k), native.ptr(v),
                native.ptr(out), B, H, KV, S, T, hd, int(bool(causal)),
                int(window), float(softcap), native.stream(q))
    native.check(rc, name)
    native.count_launch(name)
