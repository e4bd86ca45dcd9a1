"""STC-Pruner (port of ``stc_tpu/compress/pruner.py``, main-path subset).

Per chunk: keep the lowest-variance half of the channels, update the running
mean of chunk means, score each L2-normalised token by multi-bandwidth
Gaussian-RBF similarity to its frame mean and to the memory mean, and keep
the token_per_frame lowest-scoring tokens per frame, indices ascending.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from stc_tpu_torch.ops.topk import topk_lowest

ALPHAS = tuple(2.0 ** k for k in range(-3, 2))


class PrunerState(NamedTuple):
    mean_sum: torch.Tensor  # (B, C_sel) sum of per-chunk means
    count: torch.Tensor     # (B,) int32 chunks seen


def init_pruner_state(batch: int, n_selected_channels: int,
                      dtype=torch.float32, *, device) -> PrunerState:
    return PrunerState(
        mean_sum=torch.zeros((batch, n_selected_channels), dtype=dtype,
                             device=device),
        count=torch.zeros((batch,), dtype=torch.int32, device=device))


def _gaussian_similarity(feat, target):
    d2 = ((feat - target) ** 2).sum(dim=-1)
    return sum(torch.exp(-d2 / (2.0 * a)) for a in ALPHAS)


def _l2norm(x, eps=1e-12):
    return x / x.norm(dim=-1, keepdim=True).clamp(min=eps)


def stc_prune(features: torch.Tensor, state: PrunerState,
              keep_per_frame: int, channel_keep_ratio: float = 0.5):
    """features (B, F, Tin, C) -> (pruned (B, F, keep, C), kept indices
    (B, F, keep) ascending, new state)."""
    B, F_, Tin, C = features.shape
    k_ch = int(C * channel_keep_ratio)
    flat = features.to(torch.float32).reshape(B, F_ * Tin, C)
    var = flat.var(dim=1, unbiased=False)
    _, ch_idx = topk_lowest(-var, k_ch)
    sel = torch.gather(flat, 2, ch_idx[:, None, :].expand(B, F_ * Tin, k_ch))
    chunk_mean = sel.mean(dim=1)
    mean_sum = state.mean_sum + chunk_mean
    count = state.count + 1
    memory_mean = mean_sum / count[:, None].to(torch.float32)

    feat_n = _l2norm(sel.reshape(B, F_, Tin, k_ch))
    frame_score = _gaussian_similarity(feat_n,
                                       feat_n.mean(dim=2, keepdim=True))
    memory_score = _gaussian_similarity(
        feat_n, _l2norm(memory_mean)[:, None, None, :])
    combined = memory_score + frame_score
    _, idx = topk_lowest(-combined, keep_per_frame)
    idx = torch.sort(idx, dim=-1).values
    pruned = torch.gather(features, 2, idx[..., None].expand(
        B, F_, keep_per_frame, C))
    return pruned, idx, PrunerState(mean_sum=mean_sum, count=count)


def map_indices_flat(idx: torch.Tensor, tokens_per_frame: int):
    """(B, F, keep) per-frame indices -> (B, F*keep) flat-chunk indices."""
    B, F_, K = idx.shape
    off = (torch.arange(F_, dtype=idx.dtype, device=idx.device)
           * tokens_per_frame)[None, :, None]
    return (idx + off).reshape(B, F_ * K)


def map_indices_grid(idx: torch.Tensor, grid: int = 13) -> torch.Tensor:
    """Grid-with-newline-token mapping of the llava_vid layout: each
    frame's raw layout is grid x (grid + 1), grid * grid feature tokens and
    a newline token ending each row; kept feature indices (B, F, K) map into
    that layout and every row's newline token is kept.  Returns (B,
    F * (K + grid)) indices into the raw per-chunk layout."""
    B, F_, K = idx.shape
    W, Wn = grid, grid + 1
    rows, cols = idx // W, idx % W
    frame_start = (torch.arange(F_, dtype=idx.dtype, device=idx.device)
                   * (grid * Wn))[None, :, None]
    feat = frame_start + rows * Wn + cols                     # (B, F, K)
    newline = frame_start + (torch.arange(grid, dtype=idx.dtype,
                                          device=idx.device)
                             * Wn + W)[None, None, :]
    newline = newline.expand(B, F_, grid)
    return torch.cat([feat, newline], dim=-1).reshape(B, F_ * (K + grid))
