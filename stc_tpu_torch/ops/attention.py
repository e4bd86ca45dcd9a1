"""Multi-stage masked attention, plain PyTorch (port of
``stc_tpu/ops/attention.py``).

Several KV stages contribute logits to ONE joint softmax over the
concatenated key axis; masks are position-distance windows; statistics in
float32; GQA groups Hq query heads over Hkv key/value heads.  The init-prompt
append and the complement-window init stage of ``decode_attend`` use it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch


class AttnStage(NamedTuple):
    """One KV source of the joint softmax.

    k, v : (B, Hkv, Lk, D); mask : bool broadcastable to (B, 1, Lq, Lk);
    q    : optional per-stage query override (B, Hq, Lq, D).
    """

    k: torch.Tensor
    v: torch.Tensor
    mask: torch.Tensor
    q: Optional[torch.Tensor] = None


def sliding_window_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, window: int,
                        complement: bool = False) -> torch.Tensor:
    """0 <= q_pos - k_pos < window (or >= window for the complement)."""
    dist = q_pos[..., :, None] - k_pos[..., None, :]
    if complement:
        return dist >= window
    return (dist >= 0) & (dist < window)


def multi_stage_attention(q: torch.Tensor, stages: Sequence[AttnStage],
                          scale: Optional[float] = None) -> torch.Tensor:
    """Joint-softmax attention of q (B, Hq, Lq, D) over all stages' keys.
    Fully-masked rows return 0.  Returns q.dtype."""
    B, Hq, Lq, D = q.shape
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    f32 = torch.float32
    logits, masks = [], []
    for st in stages:
        Hkv, Lk = st.k.shape[1], st.k.shape[2]
        assert Hq % Hkv == 0, (Hq, Hkv)
        G = Hq // Hkv
        q_st = q if st.q is None else st.q
        qg = q_st.reshape(B, Hkv, G, Lq, D).to(f32)
        lg = torch.einsum("bhgqd,bhkd->bhgqk", qg, st.k.to(f32))
        lg = lg.reshape(B, Hq, Lq, Lk)
        m = torch.broadcast_to(st.mask, (B, 1, Lq, Lk)) \
            if st.mask.dim() < 4 or st.mask.shape[1] == 1 else st.mask
        logits.append(torch.where(m, lg * scale, float("-inf")))
        masks.append(m)
    lg = torch.cat(logits, dim=-1)
    m_max = lg.amax(dim=-1, keepdim=True)
    m_max = torch.where(torch.isfinite(m_max), m_max, 0.0)
    p = torch.exp(lg - m_max)
    denom = p.sum(dim=-1, keepdim=True)
    denom = torch.where(denom == 0.0, 1.0, denom)
    p = p / denom

    out = torch.zeros((B, Hq, Lq, D), dtype=f32, device=q.device)
    off = 0
    for st, m in zip(stages, masks):
        Hkv, Lk = st.k.shape[1], st.k.shape[2]
        G = Hq // Hkv
        p_st = torch.where(m, p[..., off:off + Lk], 0.0)
        o = torch.einsum("bhgqk,bhkd->bhgqd",
                         p_st.reshape(B, Hkv, G, Lq, Lk), st.v.to(f32))
        out = out + o.reshape(B, Hq, Lq, D)
        off += Lk
    return out.to(q.dtype)
