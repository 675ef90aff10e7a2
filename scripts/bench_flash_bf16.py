#!/usr/bin/env python3
"""Device time of the bf16 flash-attention kernel
(``src/repro_torch/kernels/csrc/flash_attention_mma.cu``) on one CUDA card,
shape by shape, beside scaled_dot_product_attention where that one call
computes the same function (causal, no window, no softcap, S = T).

  python3 scripts/bench_flash_bf16.py

One JSON line per shape: µs per launch (CUDA-graph replay between CUDA
events, as chip_smoke.py times its kernels), TFLOP/s over the (query,
key) pairs the function needs, the bound and SDPA's µs. The shapes
separate what the time depends on: the qwen3-0.6b prefill layer causal
and non-causal, hd 64 against 128, softcap and window on and off, and a
lone block's key loop (one head, S = 64 and 1024), which shows the
latency of a tile when nothing else runs beside it.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels.flash_attention import \
    flash_attention as fa  # noqa: E402

# B, H, KV, S, T, hd, causal, window, softcap
SHAPES = [
    (4, 16, 8, 1024, 1024, 128, True, 0, 0.0),
    (4, 16, 8, 1024, 1024, 128, False, 0, 0.0),
    (4, 16, 8, 1024, 1024, 64, True, 0, 0.0),
    (16, 16, 8, 1024, 1024, 128, True, 0, 0.0),
    (2, 8, 4, 1000, 1000, 64, True, 0, 0.0),
    (2, 8, 4, 1000, 1000, 64, True, 256, 0.0),
    (2, 8, 4, 1000, 1000, 64, True, 0, 50.0),
    (2, 8, 4, 1000, 1000, 64, True, 256, 50.0),
    (1, 1, 1, 64, 64, 128, True, 0, 0.0),
    (1, 1, 1, 1024, 1024, 128, False, 0, 0.0),
]


def main() -> int:
    if not torch.cuda.is_available():
        print("bench_flash_bf16: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(json.dumps({"device": torch.cuda.get_device_name(0)}), flush=True)
    for B, H, KV, S, T, hd, causal, window, cap in SHAPES:
        g = torch.Generator(device=dev).manual_seed(0)
        q = torch.randn((B, H, S, hd), generator=g, device=dev).bfloat16()
        k = torch.randn((B, KV, T, hd), generator=g, device=dev).bfloat16()
        v = torch.randn((B, KV, T, hd), generator=g, device=dev).bfloat16()
        out = torch.empty_like(q)
        kw = dict(causal=causal, window=window, softcap=cap)
        ms = cs.device_ms(lambda: fa.launch_flash_attention(q, k, v, out,
                                                            **kw))
        flops = 4 * hd * B * H * cs._flash_pairs(S, T, causal, window)
        nbytes = 2 * (2 * B * H * S * hd + 2 * B * KV * T * hd)
        b = cs.bound(nbytes, flops, cs.BF16_FLOPS_PER_S)
        sdpa = (cs._sdpa_ms(q, k, v) if causal and not window and not cap
                and S == T else None)
        print(json.dumps({
            "shape": {"B": B, "H": H, "KV": KV, "S": S, "T": T, "hd": hd,
                      "causal": causal, "window": window, "softcap": cap},
            "us": ms * 1e3, "tflop_per_s": flops / ms / 1e9,
            "bound_us": b[0] * 1e3, "bound_by": b[1],
            "sdpa_us": None if sdpa is None else sdpa * 1e3}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
