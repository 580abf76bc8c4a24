"""Deterministic synthetic data (port of ``repro.data``; the CIFAR-like
stream of the CNN experiments is not ported yet)."""
from .synthetic import SyntheticLM, lm_batch_for, make_lm_pipeline

__all__ = ["SyntheticLM", "lm_batch_for", "make_lm_pipeline"]
