"""gemma2-9b — local+global alternating attention, logit softcaps
[arXiv:2408.00118]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    num_layers=42,
    d_model=3584,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=14_336,
    vocab_size=256_000,
    sliding_window=4096,
    local_global_period=2,   # alternate local / global
    attn_softcap=50.0,
    logit_softcap=30.0,
    tie_embeddings=True,
    source="arXiv:2408.00118",
)
