"""rwkv6-1.6b 'Finch' [ssm] — 24L d=2048 attn-free, data-dependent decay,
channel-mix d_ff=7168, vocab=65536 [arXiv:2404.05892; unverified]."""
from .base import ModelConfig, QuantConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b", family="ssm",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, d_head=64,
    d_ff=7168, vocab=65536, tie_embeddings=True, dtype="bfloat16",
    quant=QuantConfig(mode="fake", n_bits=8, act_bits=8, wb_rows=8,
                      wb_cols=128),
)
