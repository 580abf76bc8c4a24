"""qwen2-vl-2b [vlm] — 28L d=1536 12H (GQA kv=2) d_ff=8960 vocab=151936,
M-RoPE, vision frontend is a STUB (the prompt supplies patch embeddings)
[arXiv:2409.12191; hf]."""
from .base import ModelConfig, QuantConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b", family="vlm",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, d_head=128,
    d_ff=8960, vocab=151936, mrope=True, qkv_bias=True, vision_tokens=256,
    rope_theta=1e6, tie_embeddings=True, dtype="bfloat16",
    quant=QuantConfig(mode="fake", n_bits=8, act_bits=8, wb_rows=8,
                      wb_cols=128),
)
