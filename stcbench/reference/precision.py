"""Where the reference rounds: float32 everywhere, or, for the control, the
nearest precision below what the configuration states.

The configuration states a bfloat16 LM and a float32 tower with TF32 off.
The control computes every LM linear layer from float8 (e4m3) operands,
each activation row and each weight output channel scaled to the format's
range, and every tower and projector product from TF32 operands (10
mantissa bits, rounded to nearest).  Attention, norms and the rest stay in
float32 in both.
"""

from __future__ import annotations

import torch

FP8_MAX = 448.0


def fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded through float8 e4m3, scaled by its absmax along `dim`."""
    s = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to TF32's 10 mantissa bits (nearest, ties away)."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


class Precision:
    """control=False: plain float32; True: the control's rounding."""

    def __init__(self, control: bool = False):
        self.control = control

    def lm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x (..., in) @ w.T for an LM weight w (out, in)."""
        if self.control:
            return fp8(x, -1) @ fp8(w, 1).T
        return x @ w.T

    def vis(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x (..., in) @ w.T for a tower or projector weight w (out, in)."""
        if self.control:
            return tf32(x) @ tf32(w).T
        return x @ w.T

    def vis_bmm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a @ b inside the tower's attention."""
        if self.control:
            return tf32(a) @ tf32(b)
        return a @ b
