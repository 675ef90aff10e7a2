"""Device resolution and the GPU parity mode.

Every entry point of the port takes ``device`` (default ``"cuda"``) and
resolves it here. A request for the card on a machine without one raises:
the port never carries on quietly on the CPU.
"""
from __future__ import annotations

import os

import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: device='cuda' requested but no CUDA device is "
            "available; pass device='cpu' explicitly to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def synchronize(device) -> None:
    """Wait for queued work on ``device`` (no-op on the CPU), so a host
    clock read afterwards includes it."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def set_parity_mode() -> None:
    """Make CUDA training steps reproducible bit for bit: no TF32 in
    cuBLAS or cuDNN, no cuDNN autotuning, deterministic algorithms only.

    cuBLAS is deterministic only with a fixed workspace, which it reads
    from ``CUBLAS_WORKSPACE_CONFIG`` at its first call; set it before
    any CUDA work (this function sets it if the caller did not)."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True)
    # deterministic mode also NaN-fills every torch.empty; the port's
    # kernels write every element of their outputs, so the fill buys
    # nothing and would sit inside every kernel timing
    torch.utils.deterministic.fill_uninitialized_memory = False
