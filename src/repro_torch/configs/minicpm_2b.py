"""minicpm-2b — dense llama-like, WSD schedule [arXiv:2404.06395]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b",
    family="dense",
    num_layers=40,
    d_model=2304,
    num_heads=36,
    num_kv_heads=36,
    head_dim=64,
    d_ff=5760,
    vocab_size=122_753,
    tie_embeddings=True,
    source="arXiv:2404.06395",
)

# WSD (warmup-stable-decay) schedule parameters — used by repro.optim
WSD = {"warmup": 0.01, "decay": 0.1, "peak_lr": 0.01}
