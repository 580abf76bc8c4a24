"""seamless-m4t-large-v2 [audio] — enc-dec 24L+24L d=1024 16H (kv=16)
d_ff=8192 vocab=256206; conformer-style speech encoder with STUB frontend
(the caller supplies frame embeddings) [arXiv:2308.11596; hf]."""
from .base import ModelConfig, QuantConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_head=64,
    d_ff=8192, vocab=256206, is_encdec=True, enc_layers=24,
    conformer_encoder=True, mlp_kind="gelu", tie_embeddings=True,
    dtype="bfloat16", quant=QuantConfig(mode="fake", n_bits=8, act_bits=8, wb_rows=8, wb_cols=128),
)
