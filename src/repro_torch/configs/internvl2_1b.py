"""internvl2-1b — VLM: InternViT (stub) feeding a small LM backbone
[arXiv:2404.16821]. The vision encoder + projector are a STUB per the
assignment; ``input_specs`` supplies patch embeddings (B, 256, d_model)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151_655,
    vision_prefix=256,
    tie_embeddings=True,
    source="arXiv:2404.16821",
)
