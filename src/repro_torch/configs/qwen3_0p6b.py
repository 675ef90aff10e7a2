"""qwen3-0.6b — dense GQA with qk-norm [hf:Qwen/Qwen3-8B family]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b",
    family="dense",
    num_layers=28,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=3072,
    vocab_size=151_936,
    qk_norm=True,
    tie_embeddings=True,
    source="hf:Qwen/Qwen3-8B",
)
