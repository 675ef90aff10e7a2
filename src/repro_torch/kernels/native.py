"""Build, load and count the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface (``extern "C"``
functions taking device pointers and a stream, returning the launch's
``cudaError_t``). At first use ``nvcc`` compiles every source into its
own shared library — one ``nvcc`` process per source, all started
together — under ``.torch_ext_build/`` at the repository root, and the
libraries are loaded with ``ctypes``. A plain C interface keeps PyTorch's
headers out of the build, which is what makes it take seconds rather
than minutes. Libraries are named by a hash of their source and flags, so
an edited source rebuilds and an unchanged one is reused.

Flags: ``sm_90a`` (Hopper), ``-O3``, and never ``--use_fast_math``: the
int8 codec must reproduce numpy's correctly rounded division and
separately rounded multiply-add bit for bit.

``LAUNCHES`` counts kernel launches by kernel name. A wrapper adds one
where it launches its kernel and nowhere else, so a run can show that
its path went through the kernels (``reset_launches``, then read).

Nothing here runs at import: building needs ``nvcc`` and a card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / ".torch_ext_build"
SOURCES = {"int8_codec": "int8_codec.cu", "fedavg_agg": "fedavg_agg.cu",
           "flash_attention": "flash_attention.cu",
           "flash_attention_mma": "flash_attention_mma.cu",
           "wkv6": "wkv6.cu"}
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "--ptxas-options=-v")

LAUNCHES: Dict[str, int] = {"quantize_packed": 0, "dequantize_packed": 0,
                            "fedavg_agg": 0, "fedavg_agg_mix": 0,
                            "flash_attention": 0,
                            "flash_attention_bf16": 0, "wkv6": 0}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
BUILD_LOG: Dict[str, str] = {}      # nvcc's output (registers, spills)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def count_launch(name: str) -> None:
    LAUNCHES[name] += 1


def use_kernel_for(t: torch.Tensor, use_kernel: Optional[bool]) -> bool:
    """``None``: the kernel for a CUDA tensor, the plain version for a
    CPU tensor. ``True`` on a CPU tensor raises (the kernels run only on
    the card); ``False`` asks for the plain version explicitly."""
    if use_kernel is None:
        return t.is_cuda
    if use_kernel and not t.is_cuda:
        raise ValueError("use_kernel=True needs a CUDA tensor; the CUDA "
                         "kernels do not run on the CPU")
    return use_kernel


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = ([str(Path(home) / "bin" / "nvcc")] if home else []) + [
        shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and Path(c).is_file():
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "are built from source at first use")


def library_path(name: str) -> Path:
    """Where the library of kernel source ``name`` is (or will be) built."""
    src = (CSRC / SOURCES[name]).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()
                            ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all() -> float:
    """Compile every kernel library that is not built yet, in parallel.
    Returns the seconds spent; raises with nvcc's output on failure."""
    with _lock:
        todo = [n for n in SOURCES if not library_path(n).is_file()]
        if not todo:
            return 0.0
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        exe = nvcc()
        t0 = time.perf_counter()
        procs = {}
        for n in todo:
            tmp = library_path(n).with_suffix(f".{os.getpid()}.tmp")
            cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[n])]
            procs[n] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        failed = []
        for n, (tmp, p) in procs.items():
            out, _ = p.communicate()
            BUILD_LOG[n] = out
            if p.returncode != 0:
                failed.append(f"--- {n} (nvcc exit {p.returncode})\n{out}")
                continue
            os.replace(tmp, library_path(n))
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
        return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel source ``name`` (built if needed)."""
    lib = _libs.get(name)
    if lib is None:
        build_all()
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
    return lib


def function(lib: str, fn: str, argtypes) -> ctypes._CFuncPtr:
    """C function ``fn`` of library ``lib`` with its signature declared
    (every pointer and the stream as ``c_void_p``, so none is cut to 32
    bits); it returns the launch's ``cudaError_t``."""
    f = getattr(library(lib), fn)
    f.argtypes = argtypes
    f.restype = ctypes.c_int
    return f


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")
