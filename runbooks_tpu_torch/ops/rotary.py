"""Rotary position embeddings, split-halves convention (Llama/NeoX),
float32 math, sin/cos made from integer positions (as
``runbooks_tpu.ops.rotary``)."""

from __future__ import annotations

import torch


def rope_sin_cos(positions: torch.Tensor, head_dim: int,
                 theta: float = 10000.0):
    """positions [...] int -> (sin, cos), each [..., head_dim//2] f32."""
    half = head_dim // 2
    exponent = (torch.arange(0, half, dtype=torch.float32,
                             device=positions.device) / half)
    freq = 1.0 / (theta ** exponent)
    angles = positions.float()[..., None] * freq
    return torch.sin(angles), torch.cos(angles)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x [batch, seq, heads, head_dim]; positions [batch, seq]."""
    dtype = x.dtype
    half = x.shape[-1] // 2
    sin, cos = rope_sin_cos(positions, x.shape[-1], theta)
    sin = sin[:, :, None, :]
    cos = cos[:, :, None, :]
    x = x.float()
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(dtype)
