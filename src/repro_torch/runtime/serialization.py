"""Versioned, ISA-independent tree serialization (the FFLY container),
byte for byte the format of ``repro.runtime.serialization``.

Format (little-endian):
  magic b"FFLY" | u32 version | u64 header_len | header JSON | blobs

The header holds the tree *skeleton* (nested dicts/lists/tuples with leaf
indices) and per-leaf dtype/shape/codec. No pickle. A container packed by
either package unpacks in the other.

Codecs:
  raw   — exact bytes (bit-exact roundtrip; default for migration)
  int8  — symmetric per-leaf int8 quantization of float leaves (v1)
  delta — v2: every float leaf of more than ``_MIN_QUANT_SIZE`` values
          is packed into ONE flat buffer at BLOCK-aligned offsets and
          int8-quantized in one kernel launch, as a residual against
          ``base`` where the base tree has the leaf, against zero
          otherwise. A leaf whose residual range exceeds
          ``fallback_ratio`` x its own range ships raw instead.

Leaves may be torch tensors (on any device) or numpy arrays; bf16 leaves
are ``torch.bfloat16`` and travel as their raw 16-bit pattern. The delta
codec works on ``device``: the packed buffer, its base and the
quantization live there, and only ``q`` and the scales come back to the
host. ``unpack_pytree`` returns a tree of tensors on ``device``.
"""
from __future__ import annotations

import json
from typing import Any, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.int8_codec import ops as codec_ops
from repro_torch.obs import telemetry as obs

MAGIC = b"FFLY"
VERSION = 2
READABLE_VERSIONS = (1, 2)

_FLOATS = ("float16", "float32", "float64", "bfloat16")

# leaves at or below this many elements ship raw: quantization savings
# can't beat the per-leaf metadata, and tiny leaves are usually
# bookkeeping whose exactness matters
_MIN_QUANT_SIZE = 64

_CHUNK = 1 << 20

_TORCH_DTYPES = {name: getattr(torch, name) for name in (
    "float16", "float32", "float64", "bfloat16", "int8", "int16", "int32",
    "int64", "uint8", "bool")}


def dtype_name(leaf) -> str:
    """The reference's dtype string of a leaf (numpy's names)."""
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return str(leaf.dtype)


def _numel(leaf) -> int:
    return leaf.numel() if isinstance(leaf, torch.Tensor) else int(leaf.size)


def _nbytes(leaf) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    return int(leaf.nbytes)


def _quantizable(leaf) -> bool:
    return dtype_name(leaf) in _FLOATS and _numel(leaf) > _MIN_QUANT_SIZE


def _torch_dtype(name: str) -> torch.dtype:
    try:
        return _TORCH_DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported leaf dtype {name!r}") from None


def _encode_skeleton(tree, leaves: List[Any]):
    if isinstance(tree, dict):
        return {"t": "dict",
                "v": {k: _encode_skeleton(tree[k], leaves)
                      for k in sorted(tree)}}
    if isinstance(tree, (list, tuple)):
        return {"t": "list" if isinstance(tree, list) else "tuple",
                "v": [_encode_skeleton(x, leaves) for x in tree]}
    leaves.append(tree if isinstance(tree, torch.Tensor)
                  else np.asarray(tree))
    return {"t": "leaf", "i": len(leaves) - 1}


def _decode_skeleton(node, leaves):
    if node["t"] == "dict":
        return {k: _decode_skeleton(v, leaves) for k, v in node["v"].items()}
    if node["t"] in ("list", "tuple"):
        seq = [_decode_skeleton(x, leaves) for x in node["v"]]
        return seq if node["t"] == "list" else tuple(seq)
    return leaves[node["i"]]


def _align_base(node, base, out: List[Any]):
    """Walk the skeleton with a (possibly partial) base tree in parallel,
    appending one entry per leaf index: the base leaf where the base tree
    has a structurally matching one, else None."""
    if node["t"] == "dict":
        for k, child in node["v"].items():
            _align_base(child, base.get(k) if isinstance(base, dict)
                        else None, out)
    elif node["t"] in ("list", "tuple"):
        seq = (list(base) if isinstance(base, (list, tuple))
               and len(base) == len(node["v"]) else [None] * len(node["v"]))
        for child, b in zip(node["v"], seq):
            _align_base(child, b, out)
    else:
        out.append(base if base is None or isinstance(base, torch.Tensor)
                   else np.asarray(base))


def _on(leaf, device) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf.to(device)
    return torch.from_numpy(np.array(leaf, copy=True)).to(device)


def _host_f32(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().float().cpu().numpy()
    return np.asarray(leaf, np.float32)


# -- per-leaf codecs (v1-compatible) ----------------------------------------

def _raw_bytes(leaf) -> bytes:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().contiguous().cpu().reshape(-1)
        return t.view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(leaf).tobytes()


def _int8_scale(leaf) -> float:
    return float(np.max(np.abs(_host_f32(leaf)))) / 127.0 or 1.0


def _leaf_from_bytes(meta: dict, blob: bytes, device) -> torch.Tensor:
    shape = tuple(meta["shape"])
    dtype = _torch_dtype(meta["dtype"])
    if meta["codec"] == "int8":
        q = np.frombuffer(blob, np.int8).reshape(shape)
        out = q.astype(np.float32) * meta["scale"]
        return torch.from_numpy(out).to(device=device, dtype=dtype)
    if not blob:
        return torch.empty(shape, dtype=dtype, device=device)
    t = torch.frombuffer(bytearray(blob), dtype=dtype).reshape(shape)
    return t.to(device)


def _lossy_flags(pairs, ratio: float, device) -> List[bool]:
    """For each (leaf, base): max|x - base| > ratio * max|x| (float32
    differences, as the reference). One host sync for all leaves."""
    if not pairs:
        return []
    stats = []
    for arr, b in pairs:
        x = _on(arr, device).float().reshape(-1)
        r = x - _on(b, device).float().reshape(-1)
        stats.append(torch.stack([x.abs().max(), r.abs().max()]))
    vals = torch.stack(stats).tolist()
    return [rmax > ratio * xmax + 1e-12 for xmax, rmax in vals]


# -- pack -------------------------------------------------------------------

def _chunks_of(blob: bytes) -> Iterator[bytes]:
    for off in range(0, len(blob), _CHUNK):
        yield blob[off:off + _CHUNK]


def pack_pytree_chunks(tree: Any, codec: str = "raw", *,
                       base: Any = None,
                       base_version: Optional[str] = None,
                       fallback_ratio: float = 1.0,
                       device="cuda",
                       use_kernel: Optional[bool] = None) -> Iterator[bytes]:
    """Yield the FFLY container incrementally: header, packed q/scale
    sections (delta), then leaf blobs in <= 1 MiB chunks. Consuming the
    whole iterator produces exactly ``pack_pytree(...)``."""
    if codec not in ("raw", "int8", "delta"):
        raise ValueError(f"unknown codec {codec!r}")
    dev = resolve_device(device)
    leaves: List[Any] = []
    skeleton = _encode_skeleton(tree, leaves)

    base_leaves: List[Any] = []
    if codec == "delta":
        _align_base(skeleton, base, base_leaves)

    # delta: the base each candidate leaf is encoded against, and which
    # of those residuals would be lossier than the leaf itself
    cand_base = {}
    if codec == "delta":
        for i, arr in enumerate(leaves):
            if not _quantizable(arr):
                continue
            b = base_leaves[i]
            if (b is None or tuple(b.shape) != tuple(arr.shape)
                    or dtype_name(b) not in _FLOATS):
                b = None
            cand_base[i] = b
    with_base = [i for i, b in cand_base.items() if b is not None]
    lossy = dict(zip(with_base, _lossy_flags(
        [(leaves[i], cand_base[i]) for i in with_base], fallback_ratio,
        dev)))

    metas: List[dict] = []
    packed_idx: List[int] = []       # leaf indices in the packed section
    packed_bases: List[Any] = []
    for i, arr in enumerate(leaves):
        dtype = dtype_name(arr)
        meta = {"dtype": dtype, "shape": list(arr.shape)}
        nbytes = _nbytes(arr)
        if i in cand_base:
            if lossy.get(i, False):
                # residual lossier than the value itself: ship the full
                # leaf bit-exact instead
                meta.update(codec="raw", nbytes=nbytes)
                metas.append(meta)
                continue
            meta.update(codec="pq", vs_base=cand_base[i] is not None,
                        nbytes=0)
            packed_idx.append(i)
            packed_bases.append(cand_base[i])
            metas.append(meta)
            continue
        if codec == "int8" and _quantizable(arr):
            meta.update(codec="int8", scale=_int8_scale(arr),
                        nbytes=_numel(arr))
            metas.append(meta)
            continue
        meta.update(codec="raw", nbytes=nbytes)
        metas.append(meta)

    header_obj = {"skeleton": skeleton, "leaves": metas, "codec": codec}
    packed_leaves = [leaves[i] for i in packed_idx]
    if codec == "delta":
        offsets = codec_ops.leaf_offsets(packed_leaves)
        n = int(offsets[-1])
        header_obj["base_version"] = base_version
        header_obj["packed"] = {
            "n": n, "scales": codec_ops.num_scales(n),
            "block": codec_ops.BLOCK, "leaves": packed_idx,
            "offsets": [int(o) for o in offsets]}

    header = json.dumps(header_obj).encode()
    yield MAGIC + VERSION.to_bytes(4, "little") \
        + len(header).to_bytes(8, "little")
    yield header

    if codec == "delta" and packed_idx:
        # the fused one-launch quantization of the whole payload
        with obs.span("mig.quantize", n=int(offsets[-1])):
            q, scales, _ = codec_ops.quantize_leaves(
                packed_leaves, packed_bases, device=dev,
                use_kernel=use_kernel)
            q_host = q.cpu().numpy()
            s_host = scales.cpu().numpy()
        yield from _chunks_of(q_host.tobytes())
        yield s_host.astype("<f4").tobytes()

    for meta, arr in zip(metas, leaves):
        if meta["codec"] == "pq":
            continue
        if meta["codec"] == "int8":
            f32 = _host_f32(arr)
            q = np.clip(np.round(f32 / meta["scale"]), -127,
                        127).astype(np.int8)
            yield from _chunks_of(q.tobytes())
        else:
            yield from _chunks_of(_raw_bytes(arr))


def pack_pytree(tree: Any, codec: str = "raw", *,
                base: Any = None, base_version: Optional[str] = None,
                fallback_ratio: float = 1.0, device="cuda",
                use_kernel: Optional[bool] = None) -> bytes:
    return b"".join(pack_pytree_chunks(
        tree, codec, base=base, base_version=base_version,
        fallback_ratio=fallback_ratio, device=device,
        use_kernel=use_kernel))


# -- unpack -----------------------------------------------------------------

def peek_base_version(data: bytes) -> Optional[str]:
    """Base version id a delta payload was encoded against (None for
    raw/int8 payloads)."""
    header, _ = _read_header(data)
    return header.get("base_version")


def _read_header(data: bytes) -> Tuple[dict, int]:
    if data[:4] != MAGIC:
        raise ValueError("not an FFLY container (bad magic)")
    version = int.from_bytes(data[4:8], "little")
    if version not in READABLE_VERSIONS:
        raise ValueError(f"unsupported FFLY version {version}")
    hlen = int.from_bytes(data[8:16], "little")
    return json.loads(data[16:16 + hlen].decode()), 16 + hlen


def unpack_pytree(data: bytes, *, base: Any = None, device="cuda",
                  use_kernel: Optional[bool] = None) -> Any:
    """Container bytes -> tree of tensors on ``device``."""
    dev = resolve_device(device)
    header, off = _read_header(data)
    metas = header["leaves"]
    leaves: List[Optional[torch.Tensor]] = [None] * len(metas)

    packed = header.get("packed")
    if packed is not None and packed["leaves"]:
        n = packed["n"]
        q = np.frombuffer(data, np.int8, count=n, offset=off)
        off += n
        scales = np.frombuffer(data, "<f4", count=packed["scales"],
                               offset=off)
        off += packed["scales"] * 4
        idx = packed["leaves"]
        offsets = np.asarray(packed["offsets"], np.int64)
        pb: List[Any] = [None] * len(idx)
        if any(metas[i].get("vs_base") for i in idx):
            if base is None:
                raise ValueError(
                    "delta payload encoded against base version "
                    f"{header.get('base_version')!r} needs base=")
            aligned: List[Any] = []
            _align_base(header["skeleton"], base, aligned)
            for j, i in enumerate(idx):
                if metas[i].get("vs_base"):
                    b = aligned[i]
                    if b is None or list(b.shape) != metas[i]["shape"]:
                        raise ValueError(
                            f"base tree is missing leaf {i} required to "
                            "decode a delta payload")
                    pb[j] = b
        decoded = codec_ops.dequantize_leaves(
            q, scales, offsets, [tuple(metas[i]["shape"]) for i in idx],
            [_torch_dtype(metas[i]["dtype"]) for i in idx], pb,
            device=dev, use_kernel=use_kernel)
        for i, arr in zip(idx, decoded):
            leaves[i] = arr

    for i, meta in enumerate(metas):
        if meta["codec"] == "pq":
            continue
        blob = data[off:off + meta["nbytes"]]
        off += meta["nbytes"]
        leaves[i] = _leaf_from_bytes(meta, blob, dev)
    return _decode_skeleton(header["skeleton"], leaves)

