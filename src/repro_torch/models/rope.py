"""Rotary position embeddings, half-split rotation (port of the standard
RoPE of ``repro.models.rope``; M-RoPE is not ported yet)."""
from __future__ import annotations

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
