"""starcoder2-15b [dense] — 40L d=6144 48H (GQA kv=4) d_ff=24576
vocab=49152, GQA + RoPE, gelu MLP with qkv bias [arXiv:2402.19173; hf]."""
from .base import ModelConfig, QuantConfig

CONFIG = ModelConfig(
    name="starcoder2-15b", family="dense",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=4, d_head=128,
    d_ff=24576, vocab=49152, mlp_kind="gelu", qkv_bias=True,
    rope_theta=1e5, tie_embeddings=True, dtype="bfloat16",
    quant=QuantConfig(mode="fake", n_bits=8, act_bits=8, wb_rows=8, wb_cols=128),
)
