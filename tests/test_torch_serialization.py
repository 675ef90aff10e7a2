"""The port's FFLY container against ``repro.runtime.serialization``.

Tolerance: none. Containers packed by the port are byte-identical to the
reference's for the same inputs (raw, int8, delta), and unpack in either
package to the same values.
"""
from __future__ import annotations

import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core.checkpoint import EdgeCheckpoint as RefCheckpoint
from repro.runtime import serialization as ref_ser
from repro_torch.core.checkpoint import EdgeCheckpoint
from repro_torch.models.vgg import params_from_reference, params_to_reference
from repro_torch.runtime import serialization as ser


def _np_tree(seed=0):
    """A checkpoint-like tree with every dtype case: f32 conv/fc/bias
    leaves, a bf16 leaf, an f64 leaf, small raw-shipped leaves, ints."""
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {
        "scalars": {"epoch": np.int64(3), "loss": np.float64(0.25),
                    "id": np.arange(64, dtype=np.uint8)},
        "params": [{"w": f32(3, 3, 32, 64), "b": f32(64)},
                   {"w": f32(1024, 128), "b": f32(128)}],
        "bf16": f32(40, 30).astype(ml_dtypes.bfloat16),
        "f64": rng.standard_normal((300,)),
        "jumpy": f32(500),                    # falls back to raw vs base
        "tiny": f32(10),
        "empty": np.zeros((0, 4), np.float32),
        "pair": (f32(70), np.int32(7)),
    }


def _np_base(tree, seed=1):
    rng = np.random.default_rng(seed)
    drift = lambda a: (a + rng.standard_normal(a.shape).astype(a.dtype)
                       * a.dtype.type(1e-3)).astype(a.dtype)
    return {
        "params": [{"w": drift(tree["params"][0]["w"]),
                    "b": drift(tree["params"][0]["b"])},
                   {"w": drift(tree["params"][1]["w"])}],   # b: no base
        "bf16": tree["bf16"],
        "f64": drift(tree["f64"]),
        "jumpy": -tree["jumpy"] * np.float32(5.0),
    }


def _to_port(tree):
    """numpy tree -> torch tree with the same bits (bf16 via its u16)."""
    if isinstance(tree, dict):
        return {k: _to_port(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_to_port(v) for v in tree]
        return out if isinstance(tree, list) else tuple(out)
    a = np.asarray(tree)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).astype(np.int32)).to(
            torch.int16).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _to_np(t):
    if isinstance(t, dict):
        return {k: _to_np(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        out = [_to_np(v) for v in t]
        return out if isinstance(t, list) else tuple(out)
    if isinstance(t, torch.Tensor) and t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16).view(
            ml_dtypes.bfloat16)
    return np.asarray(t)


def _assert_same(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        x, y = np.asarray(_to_np(a)), np.asarray(_to_np(b))
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x.reshape(-1).view(np.uint8),
                                      y.reshape(-1).view(np.uint8))


CASES = [("raw", False), ("int8", False), ("delta", False), ("delta", True)]
IDS = ["raw", "int8", "delta-zero-base", "delta-base"]


@pytest.mark.parametrize("codec,with_base", CASES, ids=IDS)
def test_container_bytes_identical(codec, with_base):
    tree = _np_tree()
    base = _np_base(tree) if with_base else None
    want = ref_ser.pack_pytree(tree, codec, base=base, base_version="v7",
                               use_pallas=False)
    got = ser.pack_pytree(_to_port(tree), codec,
                          base=None if base is None else _to_port(base),
                          base_version="v7", device="cpu")
    assert got == want
    # numpy leaves pack as tensors do (the port's bf16 leaves are tensors)
    tree.pop("bf16")
    if base is not None:
        base.pop("bf16")
    assert ser.pack_pytree(tree, codec, base=base, base_version="v7",
                           device="cpu") == ref_ser.pack_pytree(
        tree, codec, base=base, base_version="v7", use_pallas=False)


@pytest.mark.parametrize("codec,with_base", CASES, ids=IDS)
def test_chunks_concatenate_to_container(codec, with_base):
    tree = _to_port(_np_tree(2))
    base = _to_port(_np_base(_np_tree(2))) if with_base else None
    chunks = list(ser.pack_pytree_chunks(tree, codec, base=base,
                                         device="cpu"))
    assert b"".join(chunks) == ser.pack_pytree(tree, codec, base=base,
                                               device="cpu")
    assert max(len(c) for c in chunks) <= 1 << 20


@pytest.mark.parametrize("codec,with_base", CASES, ids=IDS)
def test_containers_cross_unpack(codec, with_base):
    tree = _np_tree(3)
    base = _np_base(tree) if with_base else None
    port_base = None if base is None else _to_port(base)
    from_ref = ref_ser.pack_pytree(tree, codec, base=base, use_pallas=False)
    from_port = ser.pack_pytree(_to_port(tree), codec, base=port_base,
                                device="cpu")
    a = ser.unpack_pytree(from_ref, base=port_base, device="cpu")
    b = ref_ser.unpack_pytree(from_port, base=base, use_pallas=False)
    c = ref_ser.unpack_pytree(from_ref, base=base, use_pallas=False)
    _assert_same(a, c)
    _assert_same(b, c)
    if codec == "raw":
        _assert_same(a, tree)


def test_delta_fallback_and_vs_base_flags_match():
    tree = _np_tree()
    base = _np_base(tree)
    data = ser.pack_pytree(_to_port(tree), "delta", base=_to_port(base),
                           base_version="v1", device="cpu")
    header, _ = ser._read_header(data)
    by_codec = {m["codec"] for m in header["leaves"]}
    assert by_codec == {"raw", "pq"}
    assert ser.peek_base_version(data) == "v1"


def test_checkpoint_crosses_packages():
    """A port checkpoint of torch-layout weights, converted to the
    reference layout as the scheduler ships them, packs to the same bytes
    as the reference checkpoint of the same weights, and each package
    restores the other's."""
    rng = np.random.default_rng(4)
    ref_params = [{"w": rng.standard_normal((3, 3, 64, 64)).astype(np.float32),
                   "b": rng.standard_normal(64).astype(np.float32)},
                  {"w": rng.standard_normal((1024, 128)).astype(np.float32),
                   "b": rng.standard_normal(128).astype(np.float32)}]
    ref_mu = [{k: v * np.float32(0.5) for k, v in p.items()}
              for p in ref_params]
    ref_opt = {"mu": ref_mu, "step": np.int32(5)}
    kw = dict(client_id="pi3_1", round_idx=1, epoch=1, batch_idx=2,
              split_point=2, loss=1.5, rng_seed=0)
    ref_ck = RefCheckpoint(server_params=ref_params,
                           optimizer_state=ref_opt, last_grads=ref_mu, **kw)
    port_ck = EdgeCheckpoint(
        server_params=params_to_reference(
            params_from_reference(ref_params, "cpu")),
        optimizer_state=params_to_reference(
            params_from_reference(ref_opt, "cpu")),
        last_grads=params_to_reference(params_from_reference(ref_mu, "cpu")),
        **kw)
    base = {"server_params": ref_params}
    for codec in ("raw", "delta"):
        b = base if codec == "delta" else None
        want = ref_ck.pack(codec, base=b, base_version="v0")
        got = port_ck.pack(codec, base=b, base_version="v0", device="cpu")
        assert got == want
        back = EdgeCheckpoint.unpack(want, base=b, device="cpu")
        assert back.client_id == "pi3_1" and back.batch_idx == 2
        for x, y in zip(back.server_params, port_ck.server_params):
            torch.testing.assert_close(x["w"], y["w"], rtol=0,
                                       atol=0 if codec == "raw" else 0.05)
        assert params_from_reference(back.server_params, "cpu")[0][
            "w"].shape == (64, 64, 3, 3)
