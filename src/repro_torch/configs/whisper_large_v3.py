"""whisper-large-v3 — enc-dec audio backbone; conv frontend is a stub
that supplies precomputed frame embeddings [arXiv:2212.04356]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    num_layers=32,            # decoder layers
    encoder_layers=32,
    encoder_seq=1500,         # stub conv-frontend output frames
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab_size=51_866,
    tie_embeddings=True,
    source="arXiv:2212.04356",
)
