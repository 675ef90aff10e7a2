"""arctic-480b — 128-expert top-2 MoE + dense residual
[hf:Snowflake/snowflake-arctic-base]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=4864,
    vocab_size=32_000,
    num_experts=128,
    num_experts_per_tok=2,
    moe_dense_residual=True,
    moe_dense_ff=4864,
    source="hf:Snowflake/snowflake-arctic-base",
)
