"""zamba2-1.2b [hybrid] — 38 Mamba2 layers d=2048, ssm_state=64, plus ONE
shared attention+MLP block (32H kv=32, d_ff=8192) invoked every 6 layers on
concat(hidden, embedding) [arXiv:2411.15242; hf]."""
from .base import ModelConfig, QuantConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, d_head=64,
    d_ff=8192, vocab=32000, ssm_state=64, ssm_expand=2, ssm_headdim=64,
    hybrid_attn_every=6, rope_theta=1e4, tie_embeddings=True,
    dtype="bfloat16", quant=QuantConfig(mode="fake", n_bits=8, act_bits=8,
                                        wb_rows=8, wb_cols=128),
)
