"""The port's packed int8 codec against the JAX package's numpy oracle.

Tolerance: none. The codec's q bytes and scales are the FFLY wire
format, so the port's plain version (the CPU path) and its numpy copy of
the oracle must equal ``repro.kernels.int8_codec.ref`` bit for bit (the
CUDA kernels are held to both in ``test_torch_kernels_cuda.py``).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.kernels.int8_codec import ops as ref_ops
from repro.kernels.int8_codec.ref import (dequantize_packed_ref as np_dequant,
                                          quantize_packed_ref as np_quant)
from repro_torch.kernels.int8_codec import ops
from repro_torch.kernels.int8_codec import ref
from repro_torch.kernels.int8_codec.int8_codec import (dequantize_packed,
                                                       quantize_packed)

SIZES = [0, 1, 1023, 1024, 1025, 508032]
BLOCK = 1024


def _inputs(n: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    # mixed magnitudes per block, exact zeros and ties included
    x = (rng.standard_normal(n) * np.exp(rng.uniform(-6, 3, n))
         ).astype(np.float32)
    if n > 10:
        x[::97] = 0.0
    base = (x + rng.standard_normal(n).astype(np.float32) * 1e-3
            ).astype(np.float32)
    return x, base


@pytest.mark.parametrize("residual", [False, True], ids=["plain", "residual"])
@pytest.mark.parametrize("n", SIZES)
def test_plain_quantize_bit_exact(n, residual):
    x, base = _inputs(n)
    b = base if residual else None
    q_np, s_np = np_quant(x, b)
    q, s = quantize_packed(torch.from_numpy(x),
                           None if b is None else torch.from_numpy(b))
    R = -(-n // BLOCK)
    assert q.shape == (R * BLOCK,) and s.shape == (R,)
    np.testing.assert_array_equal(q.numpy()[:n], q_np[:n])
    assert not q.numpy()[n:].any()            # the padded tail is zero
    np.testing.assert_array_equal(s.numpy().view(np.uint32),
                                  s_np.view(np.uint32))
    q_copy, s_copy = ref.quantize_packed_np(x, b)
    np.testing.assert_array_equal(q_copy, q_np)
    np.testing.assert_array_equal(s_copy, s_np)


@pytest.mark.parametrize("residual", [False, True], ids=["plain", "residual"])
@pytest.mark.parametrize("n", SIZES)
def test_plain_dequantize_bit_exact(n, residual):
    x, base = _inputs(n, seed=1)
    b = base if residual else None
    q_np, s_np = np_quant(x, b)
    # the container's trimmed form: n q-bytes, ceil(n/BLOCK) scales
    want = np_dequant(q_np[:n], s_np, n, b)
    got = dequantize_packed(torch.from_numpy(q_np[:n].copy()),
                            torch.from_numpy(s_np.copy()), n,
                            None if b is None else torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))
    np.testing.assert_array_equal(ref.dequantize_packed_np(q_np, s_np, n, b),
                                  want)


def test_dequantize_rows_without_scale_use_one():
    n = 3 * BLOCK + 5
    q = np.arange(n, dtype=np.int64) % 255 - 127
    q = q.astype(np.int8)
    scales = np.array([0.5], np.float32)       # rows 1..3 lack a scale
    got = dequantize_packed(torch.from_numpy(q), torch.from_numpy(scales), n)
    want = np_dequant(q, np.array([0.5, 1.0, 1.0, 1.0], np.float32), n)
    np.testing.assert_array_equal(got.numpy(), want)


def _leaves(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in [(3, 3, 32, 64), (1024, 128), (128,), (65,), (7, 9)]]


def test_leaf_offsets_and_pack_leaves_match_reference():
    leaves = _leaves()
    np.testing.assert_array_equal(ops.leaf_offsets(leaves),
                                  ref_ops.leaf_offsets(leaves))
    flat, offs = ops.pack_leaves(leaves, "cpu")
    flat_ref, offs_ref = ref_ops.pack_leaves(leaves)
    np.testing.assert_array_equal(offs, offs_ref)
    np.testing.assert_array_equal(flat.numpy(), flat_ref)
    assert ops.num_scales(int(offs[-1])) == ref_ops.num_scales(
        int(offs_ref[-1]))


@pytest.mark.parametrize("with_base", [False, True], ids=["zero", "base"])
def test_quantize_and_dequantize_leaves_match_reference(with_base):
    leaves = _leaves(1)
    bases = None
    if with_base:
        bases = [l + np.float32(1e-3) for l in leaves]
        bases[2] = None                          # one leaf vs a zero base
    q_ref, s_ref, off_ref = ref_ops.quantize_leaves(leaves, bases,
                                                    use_pallas=False)
    q, s, off = ops.quantize_leaves(leaves, bases, device="cpu")
    np.testing.assert_array_equal(off, off_ref)
    np.testing.assert_array_equal(q.numpy(), q_ref)
    np.testing.assert_array_equal(s.numpy(), s_ref)

    shapes = [l.shape for l in leaves]
    dts_np = [np.float32, np.float64, np.float32, np.float16, np.float32]
    dts = [torch.float32, torch.float64, torch.float32, torch.float16,
           torch.float32]
    want = ref_ops.dequantize_leaves(q_ref, s_ref, off_ref, shapes, dts_np,
                                     bases, use_pallas=False)
    got = ops.dequantize_leaves(q_ref, s_ref, off_ref, shapes, dts, bases,
                                device="cpu")
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w)
