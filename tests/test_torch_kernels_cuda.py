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
weight); fedavg_agg_mix bit-exact (the plain version follows the
kernel's order and roundings), and the int64 coefficient fold on the
card bit-exact against the CPU's; flash_attention fp32 atol = rtol = 1e-5 (the
SIMT kernel: the same function, summed in another order) and bf16 2e-2
(the tensor-core kernel: P rounded to bf16 before P·V, outputs rounded
to bf16 apart; tests/test_torch_flash_bf16.py shows on the CPU that
these roundings fit);
wkv6 atol = rtol = 1e-5 on y and the state (the 64-term read-out summed
in another order)."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels import native
from repro_torch.kernels.fedavg_agg.fedavg_agg import (fedavg_agg,
                                                       fedavg_agg_mix)
from repro_torch.kernels.fedavg_agg.ops import (coeff_finalize_tree,
                                                coeff_fold_tree,
                                                fedavg_mix_tree)
from repro_torch.kernels.flash_attention.flash_attention import \
    flash_attention_fwd
from repro_torch.kernels.int8_codec import ref
from repro_torch.kernels.int8_codec.int8_codec import (dequantize_packed,
                                                       quantize_packed)
from repro_torch.kernels.wkv6.wkv6 import wkv6
from repro_torch.tree import tree_leaves, tree_map


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


@pytest.mark.cuda
@pytest.mark.parametrize("E,N,dt", [(32, 188810, torch.float32),
                                    (1, 1000003, torch.float32),
                                    (4, 4097, torch.float32),
                                    (3, 5, torch.float32),
                                    (8, 4096, torch.bfloat16)])
def test_fedavg_agg_mix_kernel_bit_equal_to_plain_version(cuda_device, E, N,
                                                          dt):
    rng = np.random.default_rng(E * N + 1)
    stacked = torch.from_numpy(
        rng.standard_normal((E, N)).astype(np.float32)).to(cuda_device)
    g = torch.from_numpy(rng.standard_normal(N).astype(np.float32)).to(
        cuda_device).to(dt)
    w = rng.uniform(0.0, 0.5 / E, E)
    before = native.LAUNCHES["fedavg_agg_mix"]
    got = fedavg_agg_mix(g, stacked, w)
    assert native.LAUNCHES["fedavg_agg_mix"] == before + 1
    want = fedavg_agg_mix(g, stacked, w, use_kernel=False)
    assert got.dtype == dt
    assert torch.equal(got, want)


def _card_tree(rng, device):
    return {"conv": [torch.from_numpy(rng.standard_normal((8, 3, 3, 3))
                                      .astype(np.float32)).to(device),
                     torch.from_numpy(rng.standard_normal(8).astype(
                         np.float32)).to(device)],
            "fc": torch.from_numpy(rng.standard_normal((10, 40)).astype(
                np.float32)).to(device),
            "step": torch.tensor(3, dtype=torch.int32, device=device)}


def _on_cpu(tree):
    return tree_map(lambda t: t.cpu(), tree)


def _same_leaves(card_tree, cpu_tree):
    return all(torch.equal(a.cpu(), b) for a, b in
               zip(tree_leaves(card_tree), tree_leaves(cpu_tree)))


@pytest.mark.cuda
def test_fedavg_mix_tree_one_launch_per_tree(cuda_device):
    rng = np.random.default_rng(5)
    g = _card_tree(rng, cuda_device)
    ups = [_card_tree(rng, cuda_device) for _ in range(6)]
    c = list(rng.uniform(0.0, 0.1, 6))
    before = native.LAUNCHES["fedavg_agg_mix"]
    got = fedavg_mix_tree(g, ups, c)
    assert native.LAUNCHES["fedavg_agg_mix"] == before + 1
    assert got["step"] is g["step"]
    assert _same_leaves(got, fedavg_mix_tree(
        _on_cpu(g), [_on_cpu(u) for u in ups], c))


@pytest.mark.cuda
def test_coeff_fold_on_the_card_equals_cpu_fold(cuda_device):
    rng = np.random.default_rng(6)
    g = _card_tree(rng, cuda_device)
    ups = [_card_tree(rng, cuda_device) for _ in range(9)]
    c = list(rng.uniform(0.0, 0.1, 9))
    acc = coeff_fold_tree(ups, c)
    acc_cpu = coeff_fold_tree([_on_cpu(u) for u in ups], c)
    assert _same_leaves(acc, acc_cpu)
    keep = 1.0 - sum(c)
    assert _same_leaves(coeff_finalize_tree(g, keep, acc),
                        coeff_finalize_tree(_on_cpu(g), keep, acc_cpu))


# B, H, KV, S, T, hd, causal, window, softcap, dtype
FLASH_CASES = [
    (2, 4, 4, 128, 128, 64, True, 0, 0.0, torch.float32),
    (1, 16, 8, 200, 200, 128, True, 0, 0.0, torch.float32),
    (2, 8, 2, 100, 100, 64, True, 0, 0.0, torch.float32),
    (1, 4, 2, 150, 150, 64, True, 40, 50.0, torch.float32),
    (1, 4, 2, 80, 112, 64, False, 0, 0.0, torch.float32),
    (1, 2, 2, 120, 50, 64, False, 16, 50.0, torch.float32),
    (1, 8, 8, 130, 130, 128, True, 0, 0.0, torch.bfloat16),
    (2, 8, 4, 72, 72, 64, True, 24, 0.0, torch.bfloat16),
    # the bf16 tensor-core kernel: the qwen3-0.6b prefill layer
    (4, 16, 8, 1024, 1024, 128, True, 0, 0.0, torch.bfloat16),
    # S = T = 1000 at hd 64, rep 4
    (1, 16, 4, 1000, 1000, 64, True, 0, 0.0, torch.bfloat16),
    # window 256 with softcap 50
    (2, 8, 4, 700, 700, 128, True, 256, 50.0, torch.bfloat16),
    # non-causal, T < S (late rows of the window see no key) and T > S
    (1, 4, 2, 300, 100, 64, False, 64, 0.0, torch.bfloat16),
    (1, 4, 2, 80, 333, 128, False, 0, 0.0, torch.bfloat16),
    # one query row
    (1, 8, 2, 1, 1, 128, True, 0, 0.0, torch.bfloat16),
]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "B,H,KV,S,T,hd,causal,window,cap,dt", FLASH_CASES,
    ids=[f"B{c[0]}H{c[1]}KV{c[2]}S{c[3]}T{c[4]}hd{c[5]}"
         f"{'c' if c[6] else 'nc'}w{c[7]}cap{c[8]:g}"
         f"{str(c[9]).removeprefix('torch.')}" for c in FLASH_CASES])
def test_flash_attention_kernel_matches_plain_version(
        cuda_device, B, H, KV, S, T, hd, causal, window, cap, dt):
    g = torch.Generator(device=cuda_device).manual_seed(S * 7 + T)
    q = torch.randn((B, H, S, hd), generator=g, device=cuda_device).to(dt)
    k = torch.randn((B, KV, T, hd), generator=g, device=cuda_device).to(dt)
    v = torch.randn((B, KV, T, hd), generator=g, device=cuda_device).to(dt)
    kw = dict(causal=causal, window=window, softcap=cap)
    name = ("flash_attention_bf16" if dt == torch.bfloat16
            else "flash_attention")
    before = dict(native.LAUNCHES)
    got = flash_attention_fwd(q, k, v, **kw)
    assert native.LAUNCHES[name] == before[name] + 1
    assert sum(native.LAUNCHES.values()) == sum(before.values()) + 1
    want = flash_attention_fwd(q, k, v, use_kernel=False, **kw)
    tol = 2e-2 if dt == torch.bfloat16 else 1e-5
    assert got.dtype == dt and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), atol=tol,
                               rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_flash_attention_kernel_takes_misaligned_views(cuda_device, dt):
    """Contiguous views at an odd element offset (not 16-byte aligned)
    give the same result as aligned copies of the same values."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    shapes = [(1, 4, 100, 64), (1, 2, 100, 64), (1, 2, 100, 64)]
    views = []
    for shape in shapes:
        n = int(np.prod(shape))
        flat = torch.randn(n + 1, generator=g, device=cuda_device).to(dt)
        views.append(flat[1:].view(shape))
    assert all(t.is_contiguous() and t.data_ptr() % 16 for t in views)
    got = flash_attention_fwd(*views, window=32)
    want = flash_attention_fwd(*(t.clone() for t in views), window=32)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_flash_attention_kernel_refuses_other_head_dims(cuda_device):
    q = torch.zeros((1, 2, 8, 32), device=cuda_device)
    with pytest.raises(ValueError):
        flash_attention_fwd(q, q, q)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,dt", [(1, 64, 2, torch.float32),
                                      (2, 100, 3, torch.float32),
                                      (1, 1, 1, torch.float32),
                                      (2, 77, 4, torch.bfloat16)])
@pytest.mark.parametrize("carried", [False, True], ids=["zero", "state0"])
def test_wkv6_kernel_matches_plain_version(cuda_device, B, T, H, dt,
                                           carried):
    g = torch.Generator(device=cuda_device).manual_seed(T * 13 + H)
    shape = (B, T, H, 64)
    r, k, v = (torch.randn(shape, generator=g, device=cuda_device) * 0.5
               for _ in range(3))
    w = torch.sigmoid(torch.randn(shape, generator=g,
                                  device=cuda_device)) * 0.5 + 0.4
    u = torch.randn((H, 64), generator=g, device=cuda_device) * 0.1
    s0 = (torch.randn((B, H, 64, 64), generator=g, device=cuda_device)
          if carried else None)
    r, k, v, w = (t.to(dt) for t in (r, k, v, w))
    before = native.LAUNCHES["wkv6"]
    y, s = wkv6(r, k, v, w, u, s0)
    assert native.LAUNCHES["wkv6"] == before + 1
    y_p, s_p = wkv6(r, k, v, w, u, s0, use_kernel=False)
    tol = 2e-2 if dt == torch.bfloat16 else 1e-5
    assert y.dtype == dt and s.dtype == torch.float32
    torch.testing.assert_close(y.float(), y_p.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(s, s_p, atol=1e-5 if dt == torch.float32
                               else 1e-4, rtol=1e-5)


def test_kernels_refuse_cpu_tensors_when_asked():
    with pytest.raises(ValueError):
        quantize_packed(torch.zeros(4), use_kernel=True)
    with pytest.raises(ValueError):
        fedavg_agg(torch.zeros(2, 3), [1.0, 1.0], use_kernel=True)
    with pytest.raises(ValueError):
        fedavg_agg_mix(torch.zeros(3), torch.zeros(2, 3), [0.1, 0.1],
                       use_kernel=True)
    q = torch.zeros((1, 2, 8, 64))
    with pytest.raises(ValueError):
        flash_attention_fwd(q, q, q, use_kernel=True)
    x = torch.zeros((1, 4, 1, 64))
    with pytest.raises(ValueError):
        wkv6(x, x, x, x, torch.zeros(1, 64), use_kernel=True)
