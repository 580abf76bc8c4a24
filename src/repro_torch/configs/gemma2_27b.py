"""gemma2-27b [dense] — 46L d=4608 32H (GQA kv=16) d_ff=36864 vocab=256000,
alternating local(4096)/global attention, attn softcap 50, logit softcap 30,
post-norms [arXiv:2408.00118; hf]."""
from .base import ModelConfig, QuantConfig

CONFIG = ModelConfig(
    name="gemma2-27b", family="dense",
    n_layers=46, d_model=4608, n_heads=32, n_kv_heads=16, d_head=128,
    d_ff=36864, vocab=256000, sliding_window=4096, alt_local_global=True,
    attn_softcap=50.0, logit_softcap=30.0, use_post_norms=True,
    rope_theta=1e4, tie_embeddings=True, dtype="bfloat16",
    quant=QuantConfig(mode="fake", n_bits=8, act_bits=8, wb_rows=8, wb_cols=128),
)
