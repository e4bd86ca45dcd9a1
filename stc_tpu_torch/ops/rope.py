"""Rotary position embeddings (port of ``stc_tpu/ops/rope.py``).

Rotate-half (GPT-NeoX) convention; the rotation runs in float32 and is cast
back to the input dtype.  ``apply_rope_one_angle`` pins every token at the
angle of position ``index - 1`` (the position-agnostic init-key trick).
"""

from __future__ import annotations

import torch


def rope_inv_freq(dim: int, base: float = 10000.0,
                  device=None) -> torch.Tensor:
    """(dim/2,) inverse frequencies, float32."""
    exponents = torch.arange(0, dim, 2, dtype=torch.float32,
                             device=device) / dim
    return 1.0 / (base ** exponents)


def rope_cos_sin(positions: torch.Tensor, dim: int, base: float = 10000.0,
                 distance_scale: float = 1.0):
    """cos/sin tables of shape positions.shape + (dim,), float32."""
    inv_freq = rope_inv_freq(dim, base, positions.device)
    angles = positions.to(torch.float32)[..., None] * (distance_scale
                                                       * inv_freq)
    emb = torch.cat([angles, angles], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """Apply precomputed tables (broadcast against x) in float32."""
    xf = x.to(torch.float32)
    return (xf * cos + rotate_half(xf) * sin).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               base: float = 10000.0, distance_scale: float = 1.0):
    """Rotate x (..., T, D) by integer positions (T,) or (B, T) / (B, 1, T)."""
    cos, sin = rope_cos_sin(positions, x.shape[-1], base, distance_scale)
    while cos.dim() < x.dim():
        cos = cos.unsqueeze(-3)
        sin = sin.unsqueeze(-3)
    return rotate(x, cos, sin)


def apply_rope_one_angle(x: torch.Tensor, index: int, base: float = 10000.0,
                         distance_scale: float = 1.0):
    """Rotate every token of x by the single angle of position index - 1."""
    pos = torch.tensor(index - 1, dtype=torch.int32, device=x.device)
    cos, sin = rope_cos_sin(pos, x.shape[-1], base, distance_scale)
    return rotate(x, cos, sin)
