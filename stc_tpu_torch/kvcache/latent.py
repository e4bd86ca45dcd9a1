"""The streaming store of a latent-attention LM (MLA), beside the K/V page
store of ``engine.py``.

A token of a layer is one row ``[c (R) | k_pe (P)]``: the normed
compressed KV and the rope part of its key, unrotated, in the state dtype
(``models/deepseek_v3.py`` writes it).  Keys and values are the same row,
so nothing is stored twice (``state.LatentKV``).  What the ReKV engine
keeps per stream is shared with the K/V store, field for field:
``num_blocks`` / ``page_offset`` / ``length``, the window of
``engine.n_window_pages`` pages and its RoPE tables and kernel scalars
(``engine.make_rope_cache`` at head_dim P), the rep key of each block (the
mean latent row, one "kv head"), ``engine.score_blocks`` /
``engine.external_blocks`` over them and ``engine.reset_streams``.

An append writes its rows as pages, then the absorbed queries attend
``[init rows | window pages | init rows at the one angle]`` through
``ops.latent_attention``.  A question retrieves whole pages of rows by
the same scores, and decodes over a cache of rows whose rope dims are
rotated at their slot (``init_latent_decode`` .. ``latent_decode_attend``):
plain PyTorch on the CPU; on a CUDA card the decode raises, since
``decode_attention`` has no latent instance yet (``LATENT_DECODE_ON_CARD``).
"""

from __future__ import annotations

from typing import Optional

import torch

from stc_tpu_torch.config import ReKVConfig
from stc_tpu_torch.kvcache import engine
from stc_tpu_torch.kvcache.state import DecodeLatent, LatentKV
from stc_tpu_torch.ops.latent_attention import latent_attention
from stc_tpu_torch.ops.rope import rope_cos_sin, rotate

I32 = torch.int32

LATENT_DECODE_ON_CARD = (
    "question answering over a latent (MLA) store runs on the CPU only: "
    "decode_attention has no latent instance and its launcher still has "
    "open item F1; no cell can measure it before B1 (ROADMAP)")


def init_latent_kv(cfg: ReKVConfig, batch: int, width: int,
                   dtype=torch.bfloat16, *, device,
                   layers: Optional[int] = None) -> LatentKV:
    """Zeroed latent store; with `layers` every leaf gets a leading layer
    axis (the session's stacked state)."""
    if cfg.kv_quant != "none":
        raise ValueError("a latent store keeps its rows in the state dtype: "
                         f"kv_quant={cfg.kv_quant!r} is not supported")
    B, S, Nb = batch, cfg.block_size, cfg.max_blocks
    if Nb < engine.n_window_pages(cfg):
        raise ValueError(f"max_blocks={Nb} must cover the local window "
                         f"({engine.n_window_pages(cfg)} pages)")
    lead = () if layers is None else (layers,)

    def z(shape, dt=dtype):
        return torch.zeros(lead + shape, dtype=dt, device=device)

    return LatentKV(
        init_c=z((B, cfg.n_init, width)),
        block_c=z((B, Nb, S, width)),
        block_rep=z((B, cfg.rep_cap, 1, width)),
        page_keep=torch.ones(lead + (B, Nb, S), dtype=torch.bool,
                             device=device),
        num_blocks=z((B,), I32),
        page_offset=z((B,), I32),
        length=z((B,), I32))


def _rot_tail(x: torch.Tensor, P: int, cos, sin) -> torch.Tensor:
    """x with its last P dims rotated by the tables (rotate-half)."""
    return torch.cat([x[..., :-P], rotate(x[..., -P:], cos, sin)], dim=-1)


def append_latent(kv: LatentKV, q_abs: torch.Tensor, q_pe: torch.Tensor,
                  rows: torch.Tensor, cfg: ReKVConfig, *, is_init: bool,
                  scale: float, rope_base: float,
                  rope_cache: Optional[engine.RopeCache] = None
                  ) -> torch.Tensor:
    """One streaming append of T tokens into one layer's store (in place);
    returns the attention's latent output (B, T, Hq, R).

    q_abs: (B, T, Hq, R) absorbed queries; q_pe: (B, T, Hq, P) their rope
    parts, unrotated; rows: (B, T, R + P) the tokens' latent rows,
    unrotated.  If is_init the T == n_init rows become the init rows and
    attend each other causally; otherwise T is whole pages, written to the
    store with one mean row a page, then attended with the window."""
    B, T = q_abs.shape[:2]
    P = q_pe.shape[-1]
    S = cfg.block_size
    dt = kv.init_c.dtype
    if is_init:
        if T != cfg.n_init:
            raise ValueError((T, cfg.n_init))
        cos, sin = rope_cos_sin(cfg.n_local + torch.arange(
            T, device=rows.device), P, rope_base)
        kv.init_c.copy_(rows)
        q = _rot_tail(torch.cat([q_abs, q_pe], dim=-1), P, cos[:, None],
                      sin[:, None]).to(dt)
        k = _rot_tail(kv.init_c, P, cos, sin)
        dist = torch.arange(T, device=rows.device)
        mask = (dist[:, None] >= dist[None, :])[None, :, None]
        s = torch.einsum("bthw,bkw->bthk", q.float(), k.float()) * scale
        p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
        o = torch.einsum("bthk,bkr->bthr", p, kv.init_c[..., :-P].float())
        kv.length.add_(T)
        return o.to(dt)

    if T % S:
        raise ValueError(f"append of {T} tokens is not whole {S}-token pages")
    n_new = T // S
    if n_new > cfg.exc_block_size // S:
        raise ValueError(f"append of {n_new} pages exceeds exc_block_size="
                         f"{cfg.exc_block_size}")
    rc = rope_cache if rope_cache is not None else engine.make_rope_cache(
        kv.length, kv.num_blocks, T, cfg, P, rope_base, kv.page_offset)
    bidx = torch.arange(B, device=rows.device)[:, None]
    ar = torch.arange(n_new, device=rows.device)[None, :]
    slot = (kv.num_blocks - kv.page_offset).clamp(0, cfg.max_blocks - n_new)
    pages = rows.reshape(B, n_new, S, -1)
    kv.block_c[bidx, slot.to(torch.int64)[:, None] + ar] = pages.to(dt)
    rep_slot = kv.num_blocks.clamp(0, cfg.rep_cap - n_new).to(torch.int64)
    kv.block_rep[bidx, rep_slot[:, None] + ar] = pages.to(
        torch.float32).mean(dim=2)[:, :, None].to(kv.block_rep.dtype)

    q_rot, q_one, k_init_rot = attend_operands(kv, q_abs, q_pe, rc)
    o = latent_attention(q_rot, q_one, kv.block_c, rc.cos_cover,
                         rc.sin_cover, k_init_rot, kv.init_c, rc.scalars,
                         n_local=cfg.n_local, scale=scale)
    kv.num_blocks.add_(n_new)
    kv.length.add_(T)
    return o


def attend_operands(kv: LatentKV, q_abs: torch.Tensor, q_pe: torch.Tensor,
                    rc: engine.RopeCache):
    """latent_attention's query and init operands of an append: (q_rot,
    q_one (B, T, Hq, W), k_init_rot (B, n_init, W)), in the store's dtype,
    contiguous."""
    P = q_pe.shape[-1]
    dt = kv.init_c.dtype
    q = torch.cat([q_abs, q_pe], dim=-1)
    q_rot = _rot_tail(q, P, rc.cos_q[:, None], rc.sin_q[:, None]).to(dt)
    q_one = _rot_tail(q, P, rc.cos_one, rc.sin_one).to(dt)
    k_init_rot = _rot_tail(kv.init_c, P, rc.cos_init, rc.sin_init)
    return q_rot.contiguous(), q_one.contiguous(), k_init_rot.contiguous()


def retrieve_latent(kv: LatentKV, cfg: ReKVConfig, abs_idx: torch.Tensor,
                    exists: torch.Tensor):
    """The selected device-resident pages behind the init rows, valid pages
    first in ascending order (engine.retrieve_scored's order).  Returns
    (rows (B, n_init + topk * S, W) unrotated, valid_len (B,) int32)."""
    resident = exists & (abs_idx >= kv.page_offset[:, None])
    order_key = torch.where(resident, abs_idx.to(torch.int64),
                            torch.iinfo(torch.int32).max)
    order = torch.argsort(order_key, dim=1, stable=True)
    abs_sorted = torch.gather(abs_idx, 1, order)
    sel_valid = torch.gather(resident, 1, order)
    slot = (abs_sorted - kv.page_offset[:, None]).clamp(
        0, cfg.max_blocks - 1).to(torch.int64)
    B = abs_idx.shape[0]
    bidx = torch.arange(B, device=abs_idx.device)[:, None]
    pages = kv.block_c[bidx, slot].reshape(B, cfg.topk * cfg.block_size, -1)
    valid_len = (cfg.n_init + sel_valid.sum(dim=1) * cfg.block_size).to(I32)
    return torch.cat([kv.init_c, pages], dim=1), valid_len


def init_latent_decode(cfg: ReKVConfig, batch: int, width: int,
                       dtype=torch.bfloat16, *, device,
                       layers: Optional[int] = None) -> DecodeLatent:
    lead = () if layers is None else (layers,)
    return DecodeLatent(
        c=torch.zeros(lead + (batch, cfg.decode_cap, width), dtype=dtype,
                      device=device),
        cursor=torch.zeros(lead + (batch,), dtype=I32, device=device))


def _decode_device_check(t: torch.Tensor) -> None:
    if t.device.type != "cpu":
        raise NotImplementedError(LATENT_DECODE_ON_CARD)


def latent_decode_write(dkv: DecodeLatent, rows: torch.Tensor, n_tokens,
                        P: int, *, rope_base: float, at_start: bool = False
                        ) -> DecodeLatent:
    """Write T rows (B, T, W) at the cursor (slot 0 if at_start), their
    last P dims rotated at their slot (in place); returns the state with
    the advanced cursor."""
    _decode_device_check(rows)
    B, T, _ = rows.shape
    C = dkv.c.shape[1]
    dev = rows.device
    start = (torch.zeros((B,), dtype=torch.int64, device=dev) if at_start
             else dkv.cursor.to(torch.int64))
    slot = (start[:, None] + torch.arange(T, device=dev)[None, :]).clamp(
        max=C - 1)
    cos, sin = rope_cos_sin(slot, P, rope_base)
    bidx = torch.arange(B, device=dev)[:, None]
    dkv.c[bidx, slot] = _rot_tail(rows, P, cos, sin).to(dkv.c.dtype)
    n = n_tokens.to(torch.int64) if torch.is_tensor(n_tokens) else n_tokens
    return DecodeLatent(c=dkv.c, cursor=(start + n).to(I32))


def latent_decode_attend(q_abs: torch.Tensor, q_pe: torch.Tensor,
                         q_slots: torch.Tensor, dkv: DecodeLatent,
                         cfg: ReKVConfig, *, scale: float,
                         rope_base: float) -> torch.Tensor:
    """Absorbed attention of fresh queries over the decode cache: q_abs
    (B, T, Hq, R), q_pe (B, T, Hq, P) unrotated, q_slots (B, T) their
    slots; every row below the cursor within n_local of a query and not
    after it is a key.  Returns the latent output (B, T, Hq, R) in the
    cache's dtype."""
    _decode_device_check(q_abs)
    if cfg.decode_cap > cfg.n_local:
        raise ValueError(
            f"decode_cap={cfg.decode_cap} > n_local={cfg.n_local}: the "
            "complement-window init stage is not ported to the latent store")
    P = q_pe.shape[-1]
    dt = dkv.c.dtype
    cos, sin = rope_cos_sin(q_slots, P, rope_base)
    q = torch.cat([q_abs, rotate(q_pe, cos[:, :, None], sin[:, :, None])],
                  dim=-1).to(dt)
    C = dkv.c.shape[1]
    slot = torch.arange(C, device=q.device)[None, None, :]
    dist = q_slots[:, :, None].to(torch.int64) - slot
    mask = (dist >= 0) & (dist < cfg.n_local) & (
        slot < dkv.cursor[:, None, None])
    s = torch.einsum("bthw,bkw->bthk", q.float(), dkv.c.float()) * scale
    s = s.masked_fill(~mask[:, :, None], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - torch.where(torch.isfinite(m), m, 0.0))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bthk,bkr->bthr", p, dkv.c[..., :-P].float())
    return (o / torch.where(l == 0, 1.0, l)).to(dt)
