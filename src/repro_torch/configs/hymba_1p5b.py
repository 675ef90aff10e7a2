"""hymba-1.5b — hybrid parallel attention + Mamba heads [arXiv:2411.13676]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32_001,
    ssm_state=16,
    hybrid_attn_ssm=True,
    source="arXiv:2411.13676",
)
