"""MoonViT, Kimi-VL's native-resolution vision tower, on SigLIP's layer
and STC-Cacher (``models/siglip.py``).

MoonViT has SigLIP-so400m's widths and layer (pre-LN attention with q/k/v
biases, a gelu-tanh MLP) and differs in four ways, each here:

- frames at their own resolution: the tower takes (H, W) frames of one
  size, ``MoonViTConfig.image_hw``, a multiple of 28 (the processor pads
  a frame to it, ``models/kimi_vl.py``), as a grid of (H / 14, W / 14)
  patches;
- a learned 64 x 64 position grid, interpolated bicubically (half-pixel,
  no antialias) to the patch grid and added to the patch embeddings;
- a 2D RoPE on q and k of every layer: the head's 72 dims are 36
  interleaved pairs, pair 2j turned by the token's column and pair 2j + 1
  by its row, each at frequency theta ** (-4 j / 72), j < 18;
- a final LayerNorm on the last layer's output (eps 1e-5, as every norm
  of the tower), before the 2 x 2 patch merger of the projector.

The cacher runs unchanged: its gate compares a token's fresh and kept
keys, both rotated at the token's position, whose cosine is that of the
unrotated keys, and a recomputed token's query is rotated at its own
position.  The rotation runs in float32 and rounds to the tower's dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

from stc_tpu_torch.models import siglip as sg


@dataclasses.dataclass(frozen=True)
class MoonViTConfig(sg.SiglipConfig):
    image_hw: Tuple[int, int] = (364, 644)
    pos_grid: Tuple[int, int] = (64, 64)
    rope_base: float = 10000.0
    layer_norm_eps: float = 1e-5

    @property
    def grid_hw(self) -> Tuple[int, int]:
        return (self.image_hw[0] // self.patch_size,
                self.image_hw[1] // self.patch_size)

    @property
    def num_tokens(self) -> int:
        gh, gw = self.grid_hw
        return gh * gw

    @classmethod
    def tiny(cls):
        """A 2-layer tower on a 56 x 84 frame (4 x 6 patches)."""
        return cls(hidden_size=32, num_layers=2, num_heads=4,
                   intermediate_size=64, patch_size=14, image_hw=(56, 84),
                   pos_grid=(8, 8))


def rope_2d_tables(cfg: MoonViTConfig, device):
    """(cos, sin) (T, head_dim / 2) f32 of the patch grid, row-major: pair
    2j at the token's column, pair 2j + 1 at its row."""
    D = cfg.head_dim
    gh, gw = cfg.grid_hw
    freqs = 1.0 / (cfg.rope_base ** (torch.arange(
        0, D, 4, dtype=torch.float32, device=device)[:D // 4] / D))
    t = torch.arange(gh * gw, device=device)
    x = (t % gw).to(torch.float32)[:, None] * freqs
    y = (t // gw).to(torch.float32)[:, None] * freqs
    ang = torch.stack([x, y], dim=-1).reshape(gh * gw, D // 2)
    return torch.cos(ang), torch.sin(ang)


class MoonViT(sg.Siglip):
    """The tower; weights start zeroed (init_random_params or
    convert.convert_moonvit fill them).  ``pos_embed`` is the learned
    (64, 64, C) grid; ``post_ln`` the final LayerNorm, applied."""

    def __init__(self, cfg: MoonViTConfig, dtype=torch.bfloat16,
                 device="cuda"):
        super().__init__(cfg, dtype, device)
        dev = self.patch_w.device
        self.pos_embed = torch.nn.Parameter(torch.zeros(
            cfg.pos_grid + (cfg.hidden_size,), dtype=dtype, device=dev),
            requires_grad=False)
        cos, sin = rope_2d_tables(cfg, dev)
        self.register_buffer("rope_cos", cos, persistent=False)
        self.register_buffer("rope_sin", sin, persistent=False)
        for lp in self.layers:
            lp.rope = self.rotate

    def rotate(self, x: torch.Tensor, idx=None) -> torch.Tensor:
        """x (F, T, C) of the frames' tokens (or of tokens idx (F, U))
        with every head's pairs turned at the tokens' positions."""
        cos, sin = self.rope_cos, self.rope_sin
        if idx is not None:
            cos, sin = cos[idx], sin[idx]                   # (F, U, D/2)
        n, T, C = x.shape
        H = self.cfg.num_heads
        xf = x.to(torch.float32).reshape(n, T, H, -1, 2)
        a, b = xf[..., 0], xf[..., 1]
        cos, sin = cos[..., None, :], sin[..., None, :]
        out = torch.stack([a * cos - b * sin, a * sin + b * cos], dim=-1)
        return out.reshape(n, T, C).to(x.dtype)

    def positions(self) -> torch.Tensor:
        """(T, C): the position grid interpolated to the patch grid."""
        gh, gw = self.cfg.grid_hw
        grid = self.pos_embed
        if (gh, gw) == tuple(grid.shape[:2]):
            return grid.reshape(gh * gw, -1)
        y = F.interpolate(grid.to(torch.float32).permute(2, 0, 1)[None],
                          size=(gh, gw), mode="bicubic",
                          align_corners=False)
        return y[0].permute(1, 2, 0).reshape(gh * gw, -1).to(grid.dtype)

    def patch_embed(self, pixels: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) -> (B, T, C): the stride-P conv as reshape + matmul,
        then the interpolated positions."""
        B = pixels.shape[0]
        P = self.cfg.patch_size
        gh, gw = self.cfg.grid_hw
        x = pixels[:, :, :gh * P, :gw * P].reshape(B, 3, gh, P, gw, P)
        x = x.permute(0, 2, 4, 1, 3, 5).reshape(B, gh * gw, 3 * P * P)
        return x @ self.patch_w + self.patch_b + self.positions()

    def _final(self, h):
        return sg.layer_norm(h, self.post_ln_w, self.post_ln_b,
                             self.cfg.layer_norm_eps)

    @torch.no_grad()
    def encode_cached(self, pixels: torch.Tensor, cacher, update_ratio,
                      n_streams: int = 1, sim_source: str = "key",
                      k_proxy_rank: int = 0):
        if k_proxy_rank:
            raise ValueError("MoonViT's cacher gates on the rotated keys: "
                             "k_proxy_rank is not supported")
        return super().encode_cached(pixels, cacher, update_ratio, n_streams,
                                     sim_source, 0)
