"""Rotary position embeddings, float path (port of ``repro.layers.rotary``).

The angle tables are built in float32 the way the reference builds them:
``1 / theta ** (arange(half) / half)``, then ``positions * freqs``.  The
integer Q0.15 tables serve no model path yet and are not ported.
"""
from __future__ import annotations

from typing import Tuple

import torch


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions ``(...,)`` int -> (sin, cos) of shape ``(..., head_dim/2)``
    float32."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32,
                        device=positions.device) / half
    # a Python-scalar base is computed in float32 (no host-to-device copy)
    freqs = 1.0 / torch.pow(theta, exps)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x ``(B, S, H, D)``; positions ``(B, S)`` or ``(S,)``."""
    D = x.shape[-1]
    sin, cos = rope_angles(positions, D, theta)
    if sin.ndim == 2:  # (S, D/2) -> broadcast over batch
        sin, cos = sin[None], cos[None]
    sin = sin[:, :, None, :]
    cos = cos[:, :, None, :]
    x1, x2 = torch.chunk(x, 2, dim=-1)
    y1 = x1 * cos - x2 * sin  # bf16 * float32 promotes to float32
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)
