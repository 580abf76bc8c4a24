"""Architecture config schema (port of ``repro.configs.base`` and of
``QuantConfig`` from ``repro.models.common``).

Plain frozen dataclasses with the reference's field names and defaults, so
a config can be compared with its reference field by field.
"""
from __future__ import annotations

import dataclasses

from ..core.blocking import BlockingSpec


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    mode: str = "none"            # 'none' | 'bitplane' | 'fake'
    n_bits: int = 8
    wb_rows: int = 9
    wb_cols: int = 8
    per_block_scale: bool = False  # paper-faithful: per-layer scale
    act_bits: int = 32            # 32 => no activation quantization
    pact_init: float = 6.0
    quantize_embeddings: bool = False

    @property
    def spec(self) -> BlockingSpec:
        return BlockingSpec(self.wb_rows, self.wb_cols)

    @property
    def enabled(self) -> bool:
        return self.mode != "none"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0                # 0 => d_model // n_heads
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    # SSM / hybrid
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    hybrid_attn_every: int = 0
    # attention flavor
    mlp_kind: str = "swiglu"       # swiglu | gelu | relu
    qkv_bias: bool = False
    rope_theta: float = 1e4
    sliding_window: int = 0
    alt_local_global: bool = False
    attn_softcap: float = 0.0
    logit_softcap: float = 0.0
    mrope: bool = False
    use_post_norms: bool = False
    tie_embeddings: bool = True
    # enc-dec
    is_encdec: bool = False
    enc_layers: int = 0
    conformer_encoder: bool = False
    kv_cache_bits: int = 16        # 16 = float cache; 8 / 4 = quantized
    kv_cache_scale: float = 0.25
    ssm_chunk: int = 128
    rwkv_chunk: int = 32
    # quantization (BWQ-A)
    quant: QuantConfig = QuantConfig()
    # training details
    remat: bool = True
    scan_layers: bool = True
    dtype: str = "float32"         # activation/compute dtype
    # vlm stub
    vision_tokens: int = 0

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    def with_quant(self, qc: QuantConfig) -> "ModelConfig":
        return dataclasses.replace(self, quant=qc)

    def tiny(self, **over) -> "ModelConfig":
        """Reduced same-family config for CPU tests."""
        base = dict(
            n_layers=min(self.n_layers, 2 if not self.hybrid_attn_every
                         else 4),
            d_model=128, n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2)
            if self.n_kv_heads < self.n_heads else 4,
            d_ff=256, vocab=min(self.vocab, 512), d_head=32,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_headdim=32 if self.ssm_state else 64,
            sliding_window=min(self.sliding_window, 16)
            if self.sliding_window else 0,
            hybrid_attn_every=2 if self.hybrid_attn_every else 0,
            enc_layers=min(self.enc_layers, 2) if self.enc_layers else 0,
            vision_tokens=min(self.vision_tokens, 16)
            if self.vision_tokens else 0,
            remat=False,
        )
        base.update(over)
        return dataclasses.replace(self, **base)
