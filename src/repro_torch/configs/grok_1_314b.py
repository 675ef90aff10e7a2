"""grok-1-314b — 8-expert top-2 MoE [hf:xai-org/grok-1]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=32_768,
    vocab_size=131_072,
    num_experts=8,
    num_experts_per_tok=2,
    source="hf:xai-org/grok-1",
)
