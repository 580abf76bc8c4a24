"""Serve-time precision tooling over the bit-plane layout (port of
``repro.serve.autotune``).  Ported so far: :mod:`speculative`, the
truncated-plane read of the deployed leaves as a free draft model.  The
sensitivity scoring and the budgeted bit-width search wait."""
from .speculative import greedy_verify, make_draft_params

__all__ = ["greedy_verify", "make_draft_params"]
