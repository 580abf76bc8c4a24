"""phi3-mini-3.8b [dense] — 32L d=3072 32H (kv=32) d_ff=8192 vocab=32064,
RoPE + SwiGLU [arXiv:2404.14219]."""
from .base import ModelConfig, QuantConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32, d_head=96,
    d_ff=8192, vocab=32064, rope_theta=1e4, tie_embeddings=True,
    dtype="bfloat16", quant=QuantConfig(mode="fake", n_bits=8, act_bits=8,
                                        wb_rows=8, wb_cols=128),
)
