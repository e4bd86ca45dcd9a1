"""Retrieval and token scoring library (the JAX package's, ported): the
scorers of the ablation retrieval paths.

- adaptive_keyframe_sampling: recursive split until the top scores
  separate from the mean (host-side numpy, once per question on a tiny
  score vector);
- dpc_knn_select: density-peak clustering with KNN density;
- frame_change_scores / frame_change_indices: smoothed 1 - cos of
  consecutive frame features against a dynamic threshold;
- attention_mass_scores: mean attention probability of each retrieved key
  under the question queries;
- kept_token_indices: per-frame top-k keep by ratio;
- chunked_topk / select_blocks: the host-side block selection strategies
  (aks, dpc_knn, l2norm and a replica of mean_dot);
- filter_tokens: the retrieved-KV compression strategies, by name.

The numpy half is a copy of the JAX package's; the rest is torch.  Every
top-k goes through ``ops/topk.py``, so exact ties pick ``lax.top_k``'s
integers.  ``filter_tokens_random`` draws from a ``torch.Generator``: it
cannot give the JAX package's threefry permutation, only the same
structure (half of each frame, distinct indices).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from stc_tpu_torch.ops.topk import argmax_lowest, topk_lowest


# ---------------------------------------------------------------------------
# Adaptive keyframe sampling (AKS)
# ---------------------------------------------------------------------------

def adaptive_keyframe_sampling(scores: np.ndarray, max_frames: int = 64,
                               t1: float = 0.8, t2: float = -100.0,
                               max_depth: int = 5) -> List[List[int]]:
    """scores: (B, n_frames).  Returns per-batch sorted selected indices."""
    scores = np.asarray(scores, np.float64)
    out = []
    for row in scores:
        lo, hi = row.min(), row.max()
        norm = (row - lo) / (hi - lo) if hi != lo else row
        sel = _aks_recurse(list(norm), list(range(len(row))), max_frames,
                           t1, t2, max_depth, 0)
        if len(sel) > max_frames:
            sel = sorted(sel, key=lambda i: -row[i])[:max_frames]
        out.append(sorted(sel))
    return out


def _aks_recurse(scores, indices, target, t1, t2, max_depth, depth):
    if target <= 0:
        return []
    if len(scores) <= target or depth >= max_depth:
        return indices
    mean = sum(scores) / len(scores)
    std = (sum((s - mean) ** 2 for s in scores) / len(scores)) ** 0.5
    top_n = min(target, len(scores))
    top_pos = sorted(range(len(scores)), key=lambda i: -scores[i])[:top_n]
    top_mean = sum(scores[i] for i in top_pos) / top_n
    if top_mean - mean > t1 and std > t2:
        return [indices[i] for i in top_pos]
    mid = len(scores) // 2
    left_target = int(target * mid / len(scores))
    return (_aks_recurse(scores[:mid], indices[:mid], left_target, t1, t2,
                         max_depth, depth + 1)
            + _aks_recurse(scores[mid:], indices[mid:], target - left_target,
                           t1, t2, max_depth, depth + 1))


# ---------------------------------------------------------------------------
# DPC-KNN
# ---------------------------------------------------------------------------

def dpc_knn_select(x: torch.Tensor, k: int, n_keep: int) -> torch.Tensor:
    """x: (N, C).  Returns the indices (n_keep,) of the density-peak tokens,
    by descending gamma.

    rho = -mean distance to the k nearest neighbours; delta = min distance
    to any token of higher density (the max distance for the density peak);
    gamma = norm(rho) * norm(delta); keep the top gamma.  The sort and the
    peak's argmax break ties as the JAX package's do."""
    xf = x.to(torch.float32)
    d2 = ((xf[:, None, :] - xf[None, :, :]) ** 2).sum(dim=-1)
    dist = torch.sqrt(d2.clamp(min=0.0))
    knn = torch.sort(dist, dim=1).values[:, 1:k + 1]  # values: no tie rule
    rho = -knn.mean(dim=1)

    higher = rho[None, :] > rho[:, None]                     # (N, N)
    delta = torch.where(higher, dist, torch.inf).amin(dim=1)
    peak = argmax_lowest(rho)
    delta = delta.clone()
    delta[peak] = dist[peak].max()

    def norm01(v):
        return (v - v.min()) / (v.max() - v.min() + 1e-8)

    gamma = norm01(rho) * norm01(torch.where(torch.isfinite(delta), delta,
                                             0.0))
    return topk_lowest(gamma, n_keep)[1]


# ---------------------------------------------------------------------------
# Frame-change detection (MAE cosine)
# ---------------------------------------------------------------------------

def frame_change_scores(feats: torch.Tensor, moving_avg_window: int = 5):
    """feats: (B, T, C).  Returns smoothed change scores (B, T-1)."""
    a = feats[:, :-1].to(torch.float32)
    b = feats[:, 1:].to(torch.float32)
    cos = (a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1)).clamp(
        min=1e-8)
    change = 1.0 - cos                                       # (B, T-1)
    if change.shape[1] < moving_avg_window:
        return change
    # np.convolve(row, ones(w) / w, 'full')[pad:pad + n]: zero-padded
    # moving average, w - 1 - pad zeros on the left
    w = moving_avg_window
    pad = (w - 1) // 2
    n = change.shape[1]
    x = torch.nn.functional.pad(change, (w - 1 - pad, pad))
    kernel = torch.full((w,), 1.0 / w, dtype=torch.float32,
                        device=change.device)
    return torch.stack([(x[:, i:i + w] * kernel).sum(dim=-1)
                        for i in range(n)], dim=1)


def frame_change_indices(feats: torch.Tensor, moving_avg_window: int = 5,
                         threshold_factor: float = 2.0) -> List[np.ndarray]:
    """Sudden-change frame indices per batch row (host-side result)."""
    sm = frame_change_scores(feats, moving_avg_window).cpu().numpy()
    out = []
    for row in sm:
        thr = row.mean() + threshold_factor * row.std(ddof=1)
        out.append(np.where(row > thr)[0] + 1)
    return out


# ---------------------------------------------------------------------------
# Attention-mass token scoring + per-frame keeps
# ---------------------------------------------------------------------------

def attention_mass_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: (B, Hq, Lq, D); k: (B, Hkv, Lk, D) GQA-grouped.  Returns (Lk,)
    mean attention probability per key (batch 0)."""
    B, Hq, Lq, D = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, Lq, D).to(torch.float32)
    lg = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.to(torch.float32))
    lg = lg.reshape(B, Hq, Lq, -1) * (D ** -0.5)
    p = torch.softmax(lg, dim=-1)
    return p[0].mean(dim=0).mean(dim=0)


def kept_token_indices(token_scores: torch.Tensor,
                       keep_ratios: Sequence[float],
                       token_per_frame: int) -> torch.Tensor:
    """Per-frame top-k keep by ratio; returns global indices, each frame's
    by descending score."""
    outs = []
    for f in range(len(keep_ratios)):
        seg = token_scores[f * token_per_frame:(f + 1) * token_per_frame]
        keep = max(1, int(token_per_frame * keep_ratios[f]))
        outs.append(topk_lowest(seg, keep)[1] + f * token_per_frame)
    return torch.cat(outs)


# ---------------------------------------------------------------------------
# Selectable block-retrieval strategies: host-side per question, on the
# per-layer rep keys and the question's mean query
# ---------------------------------------------------------------------------

def chunked_topk(scores: np.ndarray, topk: int, chunk_size: int):
    """Chunk-grouped top-k with a remainder chunk and an overflow filter.
    scores: (n,).  Returns sorted indices."""
    n = scores.shape[0]
    if n <= topk:
        return list(range(n))
    rem = n % chunk_size
    main = scores[: n - rem].reshape(-1, chunk_size).mean(axis=-1)
    if rem > 0:
        main = np.concatenate([main, [scores[n - rem:].mean()]])
    top = np.sort(np.argsort(-main, kind="stable")[: topk // chunk_size])
    idx = (top[:, None] * chunk_size + np.arange(chunk_size)[None, :]
           ).reshape(-1)
    return [int(i) for i in idx if i < n]


def select_blocks(strategy: str, logits: np.ndarray, reps: np.ndarray,
                  q_mean: np.ndarray, topk: int, chunk_size: int):
    """Alternative block retrieval.  logits: (n,) rep . q dot scores;
    reps: (n, C) flat rep vectors; q_mean: (C,).  Returns sorted indices.

    - 'aks':     cosine scores -> adaptive keyframe sampling (t1=0.8,
                 t2=-100, max_depth=5).
    - 'dpc_knn': density-peak clustering of the rep vectors (k=20).
    - 'l2norm':  rep L2 norms as the score, chunk-grouped top-k
                 (query-independent).
    - 'mean_dot': the device scorer's replica (engine.score_blocks).
    """
    n = logits.shape[0]
    if n <= topk:
        return list(range(n))
    if strategy == "mean_dot":
        return chunked_topk(logits, topk, chunk_size)
    if strategy == "aks":
        denom = (np.linalg.norm(reps, axis=-1) * np.linalg.norm(q_mean)
                 + 1e-8)
        cos = logits / denom
        sel = adaptive_keyframe_sampling(cos[None], max_frames=topk)[0]
        return sorted(sel)
    if strategy == "dpc_knn":
        idx = dpc_knn_select(torch.from_numpy(np.asarray(reps, np.float32)),
                             k=min(20, n - 1), n_keep=min(topk, n))
        return sorted(int(i) for i in idx)
    if strategy == "l2norm":
        return chunked_topk(np.linalg.norm(reps, axis=-1), topk, chunk_size)
    raise ValueError(f"unknown retrieval scorer: {strategy}")


# ---------------------------------------------------------------------------
# Retrieved-KV compression strategies (filter_tokens_* family)
# ---------------------------------------------------------------------------

def _per_frame_bottom_half(metric: torch.Tensor, token_per_frame: int,
                           largest: bool = False) -> torch.Tensor:
    """metric: (..., T) -> (..., T // 2) indices keeping half of each frame
    by metric (the smallest, or with largest the largest), each frame's by
    rank."""
    n_frames = metric.shape[-1] // token_per_frame
    keep = token_per_frame // 2
    m = metric[..., :n_frames * token_per_frame].reshape(
        metric.shape[:-1] + (n_frames, token_per_frame))
    idx = topk_lowest(m if largest else -m, keep)[1]         # (..., F, keep)
    off = (torch.arange(n_frames, device=metric.device)
           * token_per_frame)[:, None]
    return (idx + off).reshape(metric.shape[:-1] + (n_frames * keep,))


def filter_tokens(strategy: str, video_tokens: torch.Tensor,
                  memory_mean: torch.Tensor, token_per_frame: int,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """video_tokens: (..., T, C); memory_mean: (..., C).  Returns the kept
    indices (..., T // 2) of half of each frame.  filter_tokens_random
    draws each frame's half from `generator` (on the tokens' device)."""
    x = video_tokens.to(torch.float32)
    m = memory_mean.to(torch.float32)[..., None, :]
    cos = (x * m).sum(-1) / (x.norm(dim=-1) * m.norm(dim=-1)).clamp(
        min=1e-8)
    S = token_per_frame
    if strategy in ("filter_tokens_simple", "filter_tokens_percentile"):
        return _per_frame_bottom_half(cos, S)
    if strategy == "filter_tokens_top_half":
        return _per_frame_bottom_half(cos, S, largest=True)
    if strategy == "filter_tokens_magnitude":
        return _per_frame_bottom_half(x.norm(dim=-1), S)
    if strategy == "filter_tokens_euclidean_distance":
        return _per_frame_bottom_half((x - m).norm(dim=-1), S)
    if strategy == "filter_tokens_inverse_cosine":
        return _per_frame_bottom_half(1.0 / (cos.abs() + 1e-8), S)
    if strategy == "filter_tokens_random":
        if generator is None:
            raise ValueError("filter_tokens_random needs a torch.Generator")
        n_frames = x.shape[-2] // S
        shape = x.shape[:-2] + (n_frames, S)
        # a random permutation of each frame (argsort of uniform draws),
        # its first half kept
        draw = torch.rand(shape, generator=generator, device=x.device)
        idx = torch.argsort(draw, dim=-1)[..., :S // 2]
        off = (torch.arange(n_frames, device=x.device) * S)[:, None]
        return (idx + off).reshape(x.shape[:-2] + (n_frames * (S // 2),))
    raise ValueError(f"Invalid processor_type: {strategy}")
