#!/usr/bin/env python3
"""Wall time of one qwen3-0.6b prefill (published widths, batch 4,
prompt 1024, random weights from seed 0) on one CUDA card, for the
checkout at ROOT (default: this one), under the GPU parity mode:

  python3 scripts/prefill_wall.py [ROOT] [--dtype float32|bfloat16]

A warm-up prefill, then 8 timed ones (host clock around work that ends
in torch.cuda.synchronize()); one JSON line with each wall and the
median. Run it on two checkouts in turns, in one call, to compare them.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from pathlib import Path

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?",
                    default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"))
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root) / "src"))
    import torch
    from repro_torch.data.datasets import synthetic_tokens
    from repro_torch.device import set_parity_mode
    from repro_torch.launch import steps
    from repro_torch.models.registry import build_model, get_config

    if not torch.cuda.is_available():
        print("prefill_wall: no CUDA device", file=sys.stderr)
        return 2
    set_parity_mode()
    dev = torch.device("cuda")
    cfg = get_config("qwen3-0.6b").replace(param_dtype=args.dtype,
                                           compute_dtype=args.dtype)
    model = build_model(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(0))
    batch = {"tokens": torch.from_numpy(synthetic_tokens(
        4, 1024, cfg.vocab_size, 0)["tokens"]).to(dev)}
    prefill = steps.make_prefill_step(model)
    prefill(batch)
    torch.cuda.synchronize()
    walls = []
    for _ in range(8):
        t0 = time.perf_counter()
        prefill(batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    print(json.dumps({"root": args.root, "dtype": args.dtype,
                      "device": torch.cuda.get_device_name(0),
                      "median_ms": statistics.median(walls), "ms": walls}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
