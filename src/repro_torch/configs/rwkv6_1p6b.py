"""rwkv6-1.6b "Finch" — attention-free, data-dependent decay
[arXiv:2404.05892]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    num_layers=24,
    d_model=2048,
    num_heads=32,       # wkv heads of size 64 (d_model // 64); no attention
    num_kv_heads=32,
    head_dim=64,
    d_ff=7168,
    vocab_size=65_536,
    rwkv=True,
    rope_theta=0.0,
    source="arXiv:2404.05892",
)
