"""granite-moe-3b-a800m [moe] — 32L d=1536 24H (GQA kv=8) d_ff=512/expert,
vocab=49155, 40 experts top-8 [hf:ibm-granite/granite-3.0 family; hf]."""
from .base import ModelConfig, QuantConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, d_head=64,
    d_ff=512, vocab=49155, n_experts=40, top_k=8,
    rope_theta=1e4, tie_embeddings=True, dtype="bfloat16",
    quant=QuantConfig(mode="fake", n_bits=8, act_bits=8, wb_rows=8, wb_cols=128),
)
