"""Bit-level weight representation helpers (port of the part of
``repro.core.bitrep`` the serving path needs)."""
from __future__ import annotations


def _levels(n_bits: int) -> float:
    """Largest magnitude of an ``n_bits`` unsigned grid: ``2^n - 1``."""
    return float(2 ** n_bits - 1)
