"""Deterministic synthetic data (port of ``repro.data``)."""
from .synthetic import (SyntheticCIFAR, SyntheticLM, lm_batch_for,
                        make_lm_pipeline)

__all__ = ["SyntheticCIFAR", "SyntheticLM", "lm_batch_for",
           "make_lm_pipeline"]
