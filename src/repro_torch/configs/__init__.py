"""Architecture registry.  The port's first slice serves the dense family,
so only phi3 is registered; the other architectures arrive with their
families."""
from .base import ModelConfig, QuantConfig
from .phi3_mini_3_8b import CONFIG as phi3_mini_3_8b

REGISTRY = {c.name: c for c in [phi3_mini_3_8b]}


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[name]


__all__ = ["ModelConfig", "QuantConfig", "REGISTRY", "get_config"]
