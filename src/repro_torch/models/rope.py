"""Rotary position embeddings, half-split rotation: standard RoPE and
Qwen2-VL M-RoPE (port of ``repro.models.rope``)."""
from __future__ import annotations

from typing import Optional, Sequence

import torch


def rope_angles(positions: torch.Tensor, d_head: int,
                theta: float = 1e4) -> torch.Tensor:
    """(.., S) int positions -> (.., S, d_head//2) angles."""
    half = d_head // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    inv_freq = 1.0 / (theta ** exps)
    return positions.to(torch.float32)[..., None] * inv_freq


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, dh); angles: (B, S, dh//2) -> rotated x."""
    dt = x.dtype
    half = x.shape[-1] // 2
    x1f = x[..., :half].to(torch.float32)
    x2f = x[..., half:].to(torch.float32)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    return torch.cat([x1f * cos - x2f * sin,
                      x2f * cos + x1f * sin], dim=-1).to(dt)


def mrope_angles(positions3: torch.Tensor, d_head: int, theta: float,
                 sections: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE.

    positions3: (B, S, 3) = (temporal, height, width) position ids.  The
    d_head//2 frequency slots are split into ``sections`` (t, h, w); each
    section rotates with its own position stream.  Text tokens carry equal
    (t, h, w) ids, which makes M-RoPE degenerate to standard RoPE for them.
    """
    half = d_head // 2
    if sections is None:
        # Qwen2-VL ratio (16, 24, 24)/64 generalized to any head size
        hw = 3 * half // 8
        sections = (half - 2 * hw, hw, hw)
    if sum(sections) != half:
        raise ValueError(f"sections {tuple(sections)} must sum to {half}")
    dev = positions3.device
    exps = torch.arange(half, dtype=torch.float32, device=dev) / half
    inv_freq = 1.0 / (theta ** exps)
    # the section index of each frequency slot, from host ints (a
    # tensor-valued count needs a host read, which ``meta`` has not)
    sec_id = torch.tensor([i for i, n in enumerate(sections)
                           for _ in range(n)], device=dev)
    # per-frequency-slot positions (B, S, half), as take_along_axis
    pos = torch.gather(positions3.to(torch.float32), -1,
                       sec_id.expand(*positions3.shape[:-1], half))
    return pos * inv_freq
