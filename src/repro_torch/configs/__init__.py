"""Architecture registry: ``--arch <id>`` -> ModelConfig, the reference's
ten architectures (dense, MoE, vlm, ssm, hybrid and the encoder-decoder
audio family)."""
from .base import LM_SHAPES, ModelConfig, QuantConfig, ShapeCell
from .deepseek_7b import CONFIG as deepseek_7b
from .gemma2_27b import CONFIG as gemma2_27b
from .granite_moe_3b_a800m import CONFIG as granite_moe_3b_a800m
from .llama4_scout_17b_a16e import CONFIG as llama4_scout_17b_a16e
from .phi3_mini_3_8b import CONFIG as phi3_mini_3_8b
from .qwen2_vl_2b import CONFIG as qwen2_vl_2b
from .rwkv6_1_6b import CONFIG as rwkv6_1_6b
from .seamless_m4t_large_v2 import CONFIG as seamless_m4t_large_v2
from .starcoder2_15b import CONFIG as starcoder2_15b
from .zamba2_1_2b import CONFIG as zamba2_1_2b

REGISTRY = {c.name: c for c in [
    granite_moe_3b_a800m, llama4_scout_17b_a16e, phi3_mini_3_8b,
    starcoder2_15b, deepseek_7b, gemma2_27b, zamba2_1_2b, rwkv6_1_6b,
    qwen2_vl_2b, seamless_m4t_large_v2,
]}


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[name]


__all__ = ["LM_SHAPES", "ModelConfig", "QuantConfig", "REGISTRY",
           "ShapeCell", "get_config"]
