"""Token-reduction baselines (the JAX package's experiments library,
ported), the ablation baselines set against the STC-Pruner:

- tome_merge: ToMe bipartite soft matching; the output keeps every slot
  with a keep mask (merged-away tokens masked);
- sttm_pyramid / sttm_quadtree_candidates / sttm_merge: multi-level
  quadtree spatial token merging under a budget;
- kmeans_select: k-means token reduction;
- dbdpc_reduce: DPC-KNN exemplars, every token assigned to its nearest;
- select_top_half_kv: the local-window KV compression (the engine's
  ``window_kv_compression='select_top_half'`` computes the same keep).

Every top-k, argmax and argmin breaks ties as the JAX package's does (the
lower index first).  ``kmeans_select`` draws its initial centroids from a
``torch.Generator`` (``kmeans_init``); its Lloyd iterations take any
initial indices (``kmeans_iterate``), so a test can feed the JAX package's
draw to them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from stc_tpu_torch.compress.scoring import dpc_knn_select
from stc_tpu_torch.ops.topk import argmax_lowest, topk_lowest


def _argmin_lowest(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return argmax_lowest(-x, dim=dim)


def tome_merge(metric: torch.Tensor, x: torch.Tensor, sizes: torch.Tensor,
               r: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Bipartite soft matching + component merge.

    metric: (N, Dm) similarity features; x: (N, D) tokens to merge; sizes:
    (N,) token weights.  Returns (merged_x (N, D), new_sizes (N,),
    keep_mask (N,)): kept slots hold the size-weighted component means,
    merged-away slots are masked."""
    N = metric.shape[0]
    if N % 2:
        raise ValueError("pad to an even token count")
    dev = metric.device
    A = torch.arange(0, N, 2, device=dev)
    B = torch.arange(1, N, 2, device=dev)
    sim = metric[A].to(torch.float32) @ metric[B].to(torch.float32).T
    best_B = argmax_lowest(sim, dim=-1)                      # (N/2,)
    best_val = sim.amax(dim=-1)
    r = min(r, N // 2)
    top_a = topk_lowest(best_val, r)[1]                      # A rows merged

    labels = torch.arange(N, device=dev)
    labels[A[top_a]] = B[best_B[top_a]]                      # A joins its B

    # labels are either self or a B index: one scatter-add settles all
    # components (a depth-1 label graph)
    w = sizes.to(torch.float32)
    wsum = torch.zeros((N,), dtype=torch.float32, device=dev).index_add_(
        0, labels, w)
    xsum = torch.zeros((N, x.shape[1]), dtype=torch.float32,
                       device=dev).index_add_(
        0, labels, x.to(torch.float32) * w[:, None])
    keep = wsum > 0
    merged = xsum / wsum.clamp(min=1e-8)[:, None]
    return merged.to(x.dtype), wsum.to(sizes.dtype), keep


def _adaptive_pool2(x: torch.Tensor) -> torch.Tensor:
    """(H, W, C) -> (ceil(H/2), ceil(W/2), C) average pooling with
    adaptive_avg_pool2d's bin boundaries (for even sizes avg_pool2d k=2
    s=2)."""
    def pool_axis(a, axis):
        n = a.shape[axis]
        out = -(-n // 2)
        parts = []
        for i in range(out):
            lo, hi = (i * n) // out, -(-((i + 1) * n) // out)
            parts.append(a.narrow(axis, lo, hi - lo).mean(dim=axis,
                                                          keepdim=True))
        return torch.cat(parts, dim=axis)

    return pool_axis(pool_axis(x, 0), 1)


def sttm_pyramid(frame: torch.Tensor) -> list:
    """Coarse-to-fine feature pyramid: repeated 2x average pooling until the
    coarsest level is <= 2 on a side.  frame: (H, W, C)."""
    pyr = [frame]
    while pyr[0].shape[0] > 2:
        pyr.insert(0, _adaptive_pool2(pyr[0]))
    return pyr


def sttm_quadtree_candidates(frame: torch.Tensor,
                             similarity_threshold: float = 0.85):
    """The full multi-level quadtree evaluation in static-shape form: a
    node is reached iff every ancestor failed the merge test; a reached
    node whose <= 4 children are on average cosine-similar to it above the
    threshold is a merged candidate (score = the mean similarity, area =
    its child count); reached finest-level nodes are leaf candidates
    (score 1, area 1).  Candidates partition the grid.

    Returns per-level lists (as long as the pyramid): the pyramid tokens
    (h_l, w_l, C), cand (h_l, w_l) bool, score, area, reached."""
    pyr = sttm_pyramid(frame.to(torch.float32))
    n = len(pyr)
    dev = frame.device
    sims, areas_m = [], []
    for lvl in range(n - 1):
        parent, child = pyr[lvl], pyr[lvl + 1]
        h, w, _ = parent.shape
        hn, wn = child.shape[:2]
        s_sum = torch.zeros((h, w), dtype=torch.float32, device=dev)
        s_cnt = torch.zeros((h, w), dtype=torch.float32, device=dev)
        pn = parent / parent.norm(dim=-1, keepdim=True).clamp(min=1e-8)
        cn = child / child.norm(dim=-1, keepdim=True).clamp(min=1e-8)
        for dy in range(2):
            for dx in range(2):
                cy = torch.arange(h, device=dev) * 2 + dy
                cx = torch.arange(w, device=dev) * 2 + dx
                valid = (cy[:, None] < hn) & (cx[None, :] < wn)
                cs = cn[cy.clamp(max=hn - 1)][:, cx.clamp(max=wn - 1)]
                s = (pn * cs).sum(-1)
                s_sum = s_sum + torch.where(valid, s, 0.0)
                s_cnt = s_cnt + valid
        sims.append(s_sum / s_cnt.clamp(min=1.0))
        areas_m.append(s_cnt)

    reached = [torch.ones(pyr[0].shape[:2], dtype=torch.bool, device=dev)]
    for lvl in range(n - 1):
        merged = sims[lvl] >= similarity_threshold
        hn, wn = pyr[lvl + 1].shape[:2]
        parent_open = reached[lvl] & ~merged
        ys = torch.arange(hn, device=dev) // 2
        xs = torch.arange(wn, device=dev) // 2
        reached.append(parent_open[ys][:, xs])
    cand, score, area = [], [], []
    for lvl in range(n):
        if lvl < n - 1:
            cand.append(reached[lvl] & (sims[lvl] >= similarity_threshold))
            score.append(sims[lvl])
            area.append(areas_m[lvl])
        else:
            ones = torch.ones(pyr[lvl].shape[:2], dtype=torch.float32,
                              device=dev)
            cand.append(reached[lvl])
            score.append(ones)
            area.append(ones)
    return pyr, cand, score, area, reached


def sttm_merge(frame_tokens: torch.Tensor, token_budget: int,
               similarity_threshold: float = 0.85):
    """Multi-level quadtree spatial token merging under a budget, one frame.

    frame_tokens: (H*W, C) tokens on a square grid.  Candidates are
    selected by priority = score * area: below the budget all of them,
    above it the top-budget priorities (candidates are disjoint).
    Returns (tokens (budget, C), positions (budget, 3) = (y, x, level),
    valid (budget,)); slots past the candidate count are masked invalid."""
    N, C = frame_tokens.shape
    H = int(N ** 0.5)
    if H * H != N:
        raise ValueError("square token grid expected")
    dev = frame_tokens.device
    x = frame_tokens.reshape(H, H, C)
    pyr, cand, score, area, _ = sttm_quadtree_candidates(
        x, similarity_threshold)

    toks, prios, poss = [], [], []
    for lvl, p in enumerate(pyr):
        h, w, _ = p.shape
        toks.append(p.reshape(h * w, C))
        prio = torch.where(cand[lvl], score[lvl] * area[lvl], -torch.inf)
        prios.append(prio.reshape(-1))
        yy, xx = torch.meshgrid(torch.arange(h, device=dev),
                                torch.arange(w, device=dev), indexing="ij")
        poss.append(torch.stack(
            [yy.reshape(-1), xx.reshape(-1),
             torch.full((h * w,), lvl, device=dev)], dim=1))
    all_t = torch.cat(toks, dim=0)
    all_p = torch.cat(prios, dim=0)
    all_pos = torch.cat(poss, dim=0)

    budget = min(token_budget, all_t.shape[0])
    vals, idx = topk_lowest(all_p, budget)
    return (all_t[idx].to(frame_tokens.dtype),
            all_pos[idx].to(torch.int32), torch.isfinite(vals))


def kmeans_init(n_tokens: int, n_clusters: int,
                generator: Optional[torch.Generator] = None,
                device=None) -> torch.Tensor:
    """n_clusters distinct token indices drawn from `generator` (a seed-0
    generator when None): k-means' initial centroids."""
    if generator is None:
        generator = torch.Generator(device=device or "cpu").manual_seed(0)
    perm = torch.randperm(n_tokens, generator=generator,
                          device=generator.device)
    return perm[:n_clusters].to(device or generator.device)


def kmeans_iterate(x: torch.Tensor, init_idx: torch.Tensor,
                   iters: int = 10) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lloyd's iterations from the centroids x[init_idx]: returns
    (centroids (n_clusters, C), assignment (N,)); an empty cluster keeps
    its centroid."""
    xf = x.to(torch.float32)
    n_clusters = init_idx.shape[0]
    cent = xf[init_idx.to(torch.int64)]
    for _ in range(iters):
        d2 = ((xf[:, None] - cent[None]) ** 2).sum(dim=-1)
        assign = _argmin_lowest(d2, dim=1)
        s = torch.zeros_like(cent).index_add_(0, assign, xf)
        cnt = torch.zeros((n_clusters,), dtype=torch.float32,
                          device=x.device).index_add_(
            0, assign, torch.ones_like(xf[:, 0]))
        cent = torch.where(cnt[:, None] > 0,
                           s / cnt.clamp(min=1.0)[:, None], cent)
    d2 = ((xf[:, None] - cent[None]) ** 2).sum(dim=-1)
    return cent.to(x.dtype), _argmin_lowest(d2, dim=1)


def kmeans_select(x: torch.Tensor, n_clusters: int, iters: int = 10,
                  generator: Optional[torch.Generator] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k-means token reduction: returns (centroids (n_clusters, C),
    assignment (N,)).  The initial centroids are distinct tokens drawn from
    `generator`."""
    init = kmeans_init(x.shape[0], n_clusters, generator, device=x.device)
    return kmeans_iterate(x, init, iters)


def dbdpc_reduce(x: torch.Tensor, n_keep: int, k: int = 5
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Density-based clustering reduction: n_keep density peaks by DPC-KNN,
    every token assigned to its nearest peak, the cluster means returned.
    x: (N, D).  Returns (reduced (n_keep, D), exemplar indices (n_keep,))."""
    idx = dpc_knn_select(x, k=k, n_keep=n_keep)
    centers = x[idx].to(torch.float32)
    xf = x.to(torch.float32)
    d2 = ((xf[:, None, :] - centers[None, :, :]) ** 2).sum(dim=-1)
    assign = _argmin_lowest(d2, dim=1)
    csum = torch.zeros_like(centers).index_add_(0, assign, xf)
    cnt = torch.zeros((n_keep,), dtype=torch.float32,
                      device=x.device).index_add_(
        0, assign, torch.ones_like(xf[:, 0]))
    return (csum / cnt.clamp(min=1.0)[:, None]).to(x.dtype), idx


def select_top_half_kv(local_k: torch.Tensor, local_v: torch.Tensor,
                       attn_outputs: torch.Tensor, token_per_frame: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Local-window KV compression: for each appended frame keep the
    ceil(S/2) tokens whose attention outputs have the largest head and dim
    mean.

    local_k/local_v: (B, Hkv, T, D) window tail of F = T // S whole frames;
    attn_outputs: (B, Hq, T, D).  Returns (k_kept, v_kept, kept_idx) with
    T' = F * ceil(S/2); kept_idx (B, T') indexes the tail, frame-major, in
    descending score within a frame (not re-sorted)."""
    B, Hkv, T, D = local_k.shape
    S = token_per_frame
    F_ = T // S
    keep = -(-S // 2)
    score = attn_outputs.to(torch.float32).mean(dim=(1, 3))       # (B, T)
    top = topk_lowest(score.reshape(B, F_, S), keep)[1]          # (B, F, k)
    kept_idx = (top + (torch.arange(F_, device=top.device) * S)[None, :,
                                                                None]
                ).reshape(B, F_ * keep)
    bidx = torch.arange(B, device=top.device)[:, None]
    k_kept = local_k[bidx, :, kept_idx].transpose(1, 2)
    v_kept = local_v[bidx, :, kept_idx].transpose(1, 2)
    return k_kept, v_kept, kept_idx
