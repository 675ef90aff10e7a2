"""Config dataclasses for architectures and benchmark input shapes."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description. One instance per assigned architecture.

    All sizes are *global* (unsharded). ``family`` drives which block parts
    are instantiated: dense | moe | ssm | hybrid | audio | vlm.
    """

    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # attention options
    qk_norm: bool = False
    logit_softcap: float = 0.0        # gemma2 final-logit softcap (0 = off)
    attn_softcap: float = 0.0         # gemma2 attention-logit softcap (0 = off)
    sliding_window: int = 0           # window for local layers (0 = full)
    local_global_period: int = 0      # every Nth layer global (gemma2: 2); 0 = all global
    rope_theta: float = 10_000.0

    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_dense_residual: bool = False  # arctic: dense FFN in parallel with MoE
    moe_dense_ff: int = 0             # width of that dense residual FFN
    capacity_factor: float = 1.25

    # SSM / hybrid / rwkv
    ssm_state: int = 0                # mamba state size (hymba: 16)
    hybrid_attn_ssm: bool = False     # hymba: parallel attention + SSM heads
    rwkv: bool = False                # rwkv6 data-dependent decay (attention-free)
    rwkv_chunked: bool = False        # chunk-parallel WKV6 (perf variant)
    mamba_chunked: bool = False       # chunk-parallel selective scan (perf)

    # encoder-decoder (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 0              # stub conv-frontend output frames (whisper: 1500)

    # vlm
    vision_prefix: int = 0            # stub ViT patch-embedding tokens (internvl2: 256)

    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    default_split: int = 2            # FedFly split point (layers on device stage)
    source: str = ""                  # citation

    # dtypes are strings so configs stay hashable/serializable
    param_dtype: str = "float32"
    compute_dtype: str = "float32"

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    @property
    def attn_free(self) -> bool:
        return self.rwkv

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def sub_quadratic(self) -> bool:
        """True if the arch natively supports very-long-context decode."""
        return self.rwkv or self.hybrid_attn_ssm or (
            self.sliding_window > 0 and self.local_global_period == 0
        )

    def num_params(self) -> int:
        """Analytic parameter count (embeddings + blocks + head)."""
        d, f, L = self.d_model, self.d_ff, self.num_layers
        qkv = d * self.num_heads * self.head_dim + 2 * d * self.num_kv_heads * self.head_dim
        attn = qkv + self.num_heads * self.head_dim * d
        if self.rwkv:
            attn = 4 * d * d + 2 * d  # r,k,v,o (+ decay params, approx)
        mlp = 3 * d * f
        per_layer = attn + 2 * d
        if self.is_moe:
            per_layer += self.num_experts * mlp
            if self.moe_dense_residual:
                per_layer += 3 * d * self.moe_dense_ff
            per_layer += d * self.num_experts  # router
        else:
            per_layer += mlp
        if self.hybrid_attn_ssm:
            # ssm path: in-proj (x,z,B,C,dt), out-proj
            per_layer += d * (2 * d + 2 * self.ssm_state + 1) + d * d
        emb = self.vocab_size * d
        head = 0 if self.tie_embeddings else self.vocab_size * d
        total = L * per_layer + emb + head + d
        if self.encoder_layers:
            enc_per = attn + mlp + 2 * d
            total += self.encoder_layers * enc_per
            total += L * attn  # decoder cross-attention
        return total

    def num_active_params(self) -> int:
        """Active parameters per token (MoE: only routed experts)."""
        if not self.is_moe:
            return self.num_params()
        d, f = self.d_model, self.d_ff
        dense_equiv = self.replace(num_experts=0, moe_dense_residual=False)
        base = dense_equiv.num_params()
        active_moe = self.num_experts_per_tok * 3 * d * f
        dense_res = 3 * d * self.moe_dense_ff if self.moe_dense_residual else 0
        return base + self.num_layers * (active_moe + dense_res - 3 * d * f)


@dataclass(frozen=True)
class InputShape:
    """A benchmark input shape (assigned set of 4)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


TRAIN_4K = InputShape("train_4k", 4_096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32_768, 128, "decode")
LONG_500K = InputShape("long_500k", 524_288, 1, "decode")

INPUT_SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}
