"""deepseek-7b [dense] — 30L d=4096 32H (kv=32) d_ff=11008 vocab=102400,
llama-arch [arXiv:2401.02954; hf]."""
from .base import ModelConfig, QuantConfig

CONFIG = ModelConfig(
    name="deepseek-7b", family="dense",
    n_layers=30, d_model=4096, n_heads=32, n_kv_heads=32, d_head=128,
    d_ff=11008, vocab=102400, rope_theta=1e4, tie_embeddings=True,
    dtype="bfloat16", quant=QuantConfig(mode="fake", n_bits=8, act_bits=8, wb_rows=8, wb_cols=128),
)
