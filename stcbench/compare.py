"""The gaps the check compares with its limits."""

from __future__ import annotations

import torch


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """|a - b| / |b| (Frobenius)."""
    return float((a.float() - b.float()).norm() / b.float().norm().clamp(
        min=1e-30))


def row_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest |a_i - b_i| / |b_i| over rows."""
    a, b = a.float(), b.float()
    return float(((a - b).norm(dim=-1) / b.norm(dim=-1).clamp(
        min=1e-30)).max())
