"""Architecture registry: ``--arch <id>`` -> (config, model).

The torch counterpart of ``repro.models.registry``. ``make_reduced`` is
an exact copy of the reference's, so the CPU tests' reduced shapes match.
``build_model`` builds the archs the port serves (dense and RWKV6); the
others raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs import (arctic_480b, gemma2_9b, grok_1_314b,
                                 hymba_1p5b, internvl2_1b, minicpm_2b,
                                 qwen3_0p6b, rwkv6_1p6b, whisper_large_v3,
                                 yi_6b)
from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import TransformerLM

_CONFIGS: Dict[str, ModelConfig] = {
    c.name: c for c in (
        hymba_1p5b.CONFIG, minicpm_2b.CONFIG, arctic_480b.CONFIG,
        yi_6b.CONFIG, gemma2_9b.CONFIG, whisper_large_v3.CONFIG,
        qwen3_0p6b.CONFIG, grok_1_314b.CONFIG, internvl2_1b.CONFIG,
        rwkv6_1p6b.CONFIG,
    )
}

ARCH_IDS = tuple(sorted(_CONFIGS))


def get_config(name: str) -> ModelConfig:
    if name not in _CONFIGS:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS}")
    return _CONFIGS[name]


def build_model(cfg: ModelConfig, device="cuda",
                generator: Optional[torch.Generator] = None,
                use_kernel: Optional[bool] = None) -> TransformerLM:
    return TransformerLM(cfg, device=device, generator=generator,
                         use_kernel=use_kernel)


def make_reduced(cfg: ModelConfig) -> ModelConfig:
    """Same family, smoke-test sized (2 layers, d<=512, <=4 experts)."""
    kw = dict(
        name=cfg.name + "-reduced",
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=4 if cfg.num_kv_heads == cfg.num_heads else 2,
        head_dim=64,
        d_ff=512,
        vocab_size=1024,
    )
    if cfg.rwkv:
        kw.update(num_heads=4, num_kv_heads=4)   # 256 // 64 wkv heads
    if cfg.is_moe:
        kw.update(num_experts=4, num_experts_per_tok=2)
        if cfg.moe_dense_residual:
            kw.update(moe_dense_ff=256)
    if cfg.encoder_layers:
        kw.update(encoder_layers=2, encoder_seq=64)
    if cfg.vision_prefix:
        kw.update(vision_prefix=16)
    if cfg.sliding_window:
        kw.update(sliding_window=8)
    return cfg.replace(**kw)
