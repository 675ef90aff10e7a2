"""The port's CUDA kernels against their plain PyTorch versions and the
numpy oracle, on the card. The card tests carry the ``cuda`` marker and
skip without a CUDA device.

This file imports nothing of JAX or ``repro``, so it also runs on a
machine without them; the repository's ``tests/conftest.py`` imports JAX,
so run it there with ``--noconftest``:

  PYTHONPATH=src python -m pytest -q --noconftest \\
      tests/test_torch_kernels_cuda.py

Tolerances: the int8 codec is bit-exact (its bytes are the FFLY wire
format); fedavg_agg rtol=1e-6/atol=1e-7 (float32, same summation order
as the plain version; the bound allows for a differently rounded
weight)."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels import native
from repro_torch.kernels.fedavg_agg.fedavg_agg import fedavg_agg
from repro_torch.kernels.int8_codec import ref
from repro_torch.kernels.int8_codec.int8_codec import (dequantize_packed,
                                                       quantize_packed)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _inputs(n: int, seed: int):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * np.exp(rng.uniform(-6, 3, n))
         ).astype(np.float32)
    x[::97] = 0.0
    base = (x + rng.standard_normal(n).astype(np.float32) * 1e-3
            ).astype(np.float32)
    return x, base


@pytest.mark.cuda
@pytest.mark.parametrize("residual", [False, True], ids=["plain", "residual"])
@pytest.mark.parametrize("n", [1, 1025, 513024, 1000003])
def test_codec_kernels_bit_exact(cuda_device, n, residual):
    x, base = _inputs(n, seed=n)
    b = base if residual else None
    xd = torch.from_numpy(x).to(cuda_device)
    bd = None if b is None else torch.from_numpy(b).to(cuda_device)
    before = dict(native.LAUNCHES)
    q, s = quantize_packed(xd, bd)
    assert native.LAUNCHES["quantize_packed"] == \
        before["quantize_packed"] + 1
    q_p, s_p = quantize_packed(xd, bd, use_kernel=False)
    q_np, s_np = ref.quantize_packed_np(x, b)
    assert torch.equal(q, q_p) and torch.equal(s, s_p)
    np.testing.assert_array_equal(q.cpu().numpy()[:n], q_np[:n])
    np.testing.assert_array_equal(s.cpu().numpy(), s_np)

    out = dequantize_packed(q[:n], s, n, bd)
    out_p = dequantize_packed(q[:n], s, n, bd, use_kernel=False)
    assert torch.equal(out, out_p)
    np.testing.assert_array_equal(
        out.cpu().numpy(), ref.dequantize_packed_np(q_np[:n], s_np, n, b))
    few = s[:max(s.numel() - 1, 0)]
    assert torch.equal(dequantize_packed(q[:n], few, n, bd),
                       dequantize_packed(q[:n], few, n, bd,
                                         use_kernel=False))


@pytest.mark.cuda
@pytest.mark.parametrize("E,N", [(4, 188810), (4, 1000003), (1, 5)])
def test_fedavg_agg_kernel_matches_plain_version(cuda_device, E, N):
    rng = np.random.default_rng(E * N)
    stacked = torch.from_numpy(
        rng.standard_normal((E, N)).astype(np.float32)).to(cuda_device)
    w = rng.uniform(0.5, 2.0, E)
    before = native.LAUNCHES["fedavg_agg"]
    got = fedavg_agg(stacked, w)
    assert native.LAUNCHES["fedavg_agg"] == before + 1
    want = fedavg_agg(stacked, w, use_kernel=False)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)


def test_kernels_refuse_cpu_tensors_when_asked():
    with pytest.raises(ValueError):
        quantize_packed(torch.zeros(4), use_kernel=True)
    with pytest.raises(ValueError):
        fedavg_agg(torch.zeros(2, 3), [1.0, 1.0], use_kernel=True)
