"""Serving launcher: batched prefill + greedy decode of a dense or RWKV6
arch on the card (or the CPU, when asked).

Prefill a batch of synthetic prompts (collecting the decode cache), then
step the decoder one token at a time with greedy sampling. Parameters are
random, drawn on the device from ``--seed``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
      --no-reduced --device cuda --batch 4 --prompt-len 1024 --gen 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \\
      --reduced --device cpu

``--reduced/--no-reduced`` picks the smoke-test width or the published
one. The reference declares ``--reduced`` as ``store_true`` with default
True, so its full width cannot be reached; here the same knob (default:
reduced) can be turned off.
"""
from __future__ import annotations

import argparse
import logging
import time
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.data.datasets import synthetic_tokens
from repro_torch.device import resolve_device, synchronize
from repro_torch.launch import steps as steps_lib
from repro_torch.models.registry import build_model, get_config, make_reduced

log = logging.getLogger("repro_torch.launch.serve")


def build_cache_from_prefill(model, cfg, batch, prompt_len: int,
                             total_len: int):
    """Run prefill, then seed a decode cache of ``total_len`` positions
    with what it collected. Returns (last-token logits (B, 1, V),
    cache)."""
    B = batch["tokens"].shape[0]
    logits, aux = steps_lib.make_prefill_step(model)(batch)
    cache = model.init_cache(B, total_len)
    if cfg.rwkv:
        cache.update({k: aux[k] for k in
                      ("rwkv_state", "rwkv_xprev", "cmix_xprev")})
        return logits, cache
    C = cache["k"].shape[2]
    S = min(prompt_len, C)
    cache["k"][:, :, :S] = aux["k"][:, :, -S:].to(cache["k"].dtype)
    cache["v"][:, :, :S] = aux["v"][:, :, -S:].to(cache["v"].dtype)
    cache["pos_tab"][:, :, :S] = torch.arange(
        prompt_len - S, prompt_len, dtype=torch.int32, device=model.device)
    return logits, cache


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """(B, 1, V) logits -> (B, 1) int32 argmax tokens, on their device."""
    return torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)


def generate(model, cache, logits: torch.Tensor, start_pos: int,
             steps: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy decode: the token picked from ``logits`` goes in at
    ``start_pos``, then ``steps`` more. Returns (tokens (B, steps + 1),
    the last logits); ``cache`` is updated in place."""
    serve = steps_lib.make_serve_step(model)
    tok = greedy(logits)
    out = [tok]
    for i in range(steps):
        logits, cache = serve(cache, tok, start_pos + i)
        tok = greedy(logits)
        out.append(tok)
    return torch.cat(out, dim=1), logits


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("-v", "--verbose", action="store_true")
    ap.add_argument("-q", "--quiet", action="store_true")
    args = ap.parse_args(argv)
    level = (logging.DEBUG if args.verbose else
             logging.WARNING if args.quiet else logging.INFO)
    logging.basicConfig(level=level, format="%(name)s: %(message)s")

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = make_reduced(cfg)
    model = build_model(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(args.seed))

    B, S = args.batch, args.prompt_len
    batch = {"tokens": torch.from_numpy(synthetic_tokens(
        B, S, cfg.vocab_size, args.seed)["tokens"]).to(dev)}

    synchronize(dev)
    t0 = time.perf_counter()
    logits, cache = build_cache_from_prefill(model, cfg, batch, S,
                                             S + args.gen)
    synchronize(dev)
    dt = time.perf_counter() - t0
    log.info("prefill: %dx%d tokens in %.3fs (%.1f tok/s)", B, S, dt,
             B * S / max(dt, 1e-9))

    t0 = time.perf_counter()
    gen, logits = generate(model, cache, logits, S, args.gen - 1)
    synchronize(dev)
    dt = time.perf_counter() - t0
    log.info("decode: %d steps x %d seqs in %.3fs (%.1f tok/s)",
             args.gen - 1, B, dt, (args.gen - 1) * B / max(dt, 1e-9))
    gen = gen.cpu().numpy()
    for b in range(min(B, 2)):
        log.info("  seq%d: %s", b, gen[b].tolist())
    if not bool(torch.isfinite(logits).all()):
        raise RuntimeError("non-finite logits")
    log.info("ok")


if __name__ == "__main__":
    main()
