"""Serving steps: prefill and one-token decode.

The torch counterpart of ``repro.launch.steps``'s ``make_prefill_step``
and ``make_serve_step``. The model owns its parameters, so the steps
close over it; both run without autograd. The training, multi-pod and
FedAvg steps wait for the SPMD slice.
"""
from __future__ import annotations

from typing import Callable

import torch


def make_prefill_step(model) -> Callable:
    """batch -> (last-token logits (B, 1, V), prefill cache entries
    stacked on a leading L axis). Only the last position reaches the
    head: a (B, S, V) float32 logit tensor is never made."""

    @torch.no_grad()
    def prefill_step(batch):
        x, aux = model.hidden(batch, collect_cache=True)
        return model.logits(x[:, -1:]), aux

    return prefill_step


def make_serve_step(model) -> Callable:
    """(cache, tokens (B, 1), pos) -> (logits (B, 1, V), cache): ONE new
    token against the cache, which is updated in place."""

    @torch.no_grad()
    def serve_step(cache, tokens, pos):
        return model.decode_step(cache, tokens, pos)

    return serve_step
