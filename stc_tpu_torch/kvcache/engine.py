"""Streaming KV-cache engine, main-path subset (port of
``stc_tpu/kvcache/engine.py``).

Plain functions on tensors.  Unlike the JAX engine, which returns new
arrays, page and decode-cache writes land IN PLACE in the tensors the state
holds (the page store is gigabytes at llava-ov-0.5b shapes); counters are
updated in place too.  Every function returns the state it was given, so
call sites read like the JAX ones.

Attention: every video append goes through ``ops.stream_attention`` and
every QA forward through ``ops.decode_attention``.  Their wrappers launch
the CUDA kernel on a CUDA tensor and run the plain PyTorch version on a CPU
tensor; there is no other route.  The JAX session's window-size buckets and
backend switches are not ported: the kernel skips the empty tiles of the
full window, so it always reads the whole window cover.  The one exception
is static: with decode_cap > n_local, ``decode_attend`` needs the
complement-window init stage, which no kernel computes (in the JAX engine
either), and runs the plain multi-stage attention on every device.

Quantized pages (``ReKVConfig.kv_quant`` 'int8' or 'int4'): pages are
quantized on write with per-(page, head, dim) absmax scales over the S
token rows; ``stream_attention`` reads them as they are stored and
dequantizes inside the kernel; retrieval dequantizes the gathered pages.
Rep keys come from the exact keys, so retrieval scoring does not see the
quantization.

Multi-stream state: ``append_stream(active=)`` leaves inactive streams
bit-identical (ragged ingest), ``reset_streams`` recycles slots, and
``external_blocks`` takes externally chosen blocks in place of the top-k.
After host-tier evictions (``host_tier.py``) the store holds absolute
pages from page_offset on; ``retrieve_blocks_hosttier`` serves the rest
from the session's prefetch table of staged host pages.

Ablations: with ``window_kv_compression='select_top_half'`` every append
passes the window's page keep rows to ``stream_attention`` (the kernel
masks dropped keys) and then keeps, per new page, the ceil(S/2) tokens of
largest mean attention output; ``compress_retrieved`` keeps half of each
retrieved block's tokens by a ``filter_tokens_*`` strategy.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from stc_tpu_torch.compress.scoring import filter_tokens
from stc_tpu_torch.config import ReKVConfig
from stc_tpu_torch.kvcache.state import DecodeKV, StreamKV
from stc_tpu_torch.ops.attention import AttnStage, multi_stage_attention
from stc_tpu_torch.ops.decode_attention import decode_attention
from stc_tpu_torch.ops.rope import apply_rope, rope_cos_sin, rotate
from stc_tpu_torch.ops.stream_attention import (dequant_rows, pages_per_tile,
                                                stream_attention)
from stc_tpu_torch.ops.stream_attention import unpack_int4 as _unpack_int4
from stc_tpu_torch.ops.topk import topk_lowest

I32 = torch.int32


def n_window_pages(cfg: ReKVConfig) -> int:
    """ceil(n_local/S) + the pages of one append, rounded up to 8 (a
    multiple of pages_per_tile)."""
    S = cfg.block_size
    w0 = -(-cfg.n_local // S) + cfg.exc_block_size // S
    return -(-w0 // 8) * 8


def init_stream_kv(cfg: ReKVConfig, batch: int, n_kv_heads: int,
                   head_dim: int, dtype=torch.bfloat16, *, device,
                   layers: Optional[int] = None) -> StreamKV:
    """Zeroed stream state; with `layers` every leaf gets a leading layer
    axis (the session's stacked state)."""
    B, H, D, S, Nb = batch, n_kv_heads, head_dim, cfg.block_size, \
        cfg.max_blocks
    if Nb < n_window_pages(cfg):
        raise ValueError(f"max_blocks={Nb} must cover the local window "
                         f"({n_window_pages(cfg)} pages)")
    lead = () if layers is None else (layers,)

    def z(shape, dt=dtype):
        return torch.zeros(lead + shape, dtype=dt, device=device)

    if cfg.kv_quant == "int4":
        if D % 2:
            raise ValueError(f"int4 pages pack two dims a byte: head_dim={D}")
        page_dt, Dp = torch.uint8, D // 2
    elif cfg.kv_quant == "int8":
        page_dt, Dp = torch.int8, D
    else:
        page_dt, Dp = dtype, D
    n_scale = Nb if cfg.kv_quant != "none" else 0
    return StreamKV(
        init_k=z((B, H, cfg.n_init, D)),
        init_v=z((B, H, cfg.n_init, D)),
        block_k=z((B, H, Nb, S, Dp), page_dt),
        block_v=z((B, H, Nb, S, Dp), page_dt),
        block_k_scale=z((B, H, n_scale, D), torch.float32),
        block_v_scale=z((B, H, n_scale, D), torch.float32),
        block_rep=z((B, cfg.rep_cap, H, D)),
        page_keep=torch.ones(lead + (B, Nb, S), dtype=torch.bool,
                             device=device),
        num_blocks=z((B,), I32),
        page_offset=z((B,), I32),
        length=z((B,), I32),
    )


def init_decode_kv(cfg: ReKVConfig, batch: int, n_kv_heads: int,
                   head_dim: int, dtype=torch.bfloat16, *, device,
                   layers: Optional[int] = None) -> DecodeKV:
    lead = () if layers is None else (layers,)
    shape = lead + (batch, n_kv_heads, cfg.decode_cap, head_dim)
    return DecodeKV(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        cursor=torch.zeros(lead + (batch,), dtype=I32, device=device))


def reset_streams(kv: StreamKV, reset: torch.Tensor, init_len: int,
                  batch_axis: int = 0) -> StreamKV:
    """Return the slots where reset (B,) bool is set to their just-after-
    init-prompt state, in place: counters to zero (length to init_len),
    rep keys to zero, page keep masks to ones.  The init tokens stay
    (every slot shares the init prompt) and page data stays stale: every
    reader gates by num_blocks and positions, and new appends overwrite
    from slot 0.  batch_axis: 0 for a layer's state, 1 for the session's
    layer-stacked one."""
    idx = reset.nonzero().reshape(-1).to(kv.num_blocks.device)
    kv.block_rep.index_fill_(batch_axis, idx, 0)
    kv.page_keep.index_fill_(batch_axis, idx, True)
    kv.num_blocks.index_fill_(batch_axis, idx, 0)
    kv.page_offset.index_fill_(batch_axis, idx, 0)
    kv.length.index_fill_(batch_axis, idx, init_len)
    return kv


# ---------------------------------------------------------------------------
# RoPE tables and kernel scalars (shared by every layer of one append)
# ---------------------------------------------------------------------------

class RopeCache(NamedTuple):
    cos_q: torch.Tensor      # (T, D) queries at window-relative positions
    sin_q: torch.Tensor
    cos_one: torch.Tensor    # (D,) one angle for the init-far group
    sin_one: torch.Tensor
    cos_init: torch.Tensor   # (B, n_init, D) init keys, window-relative
    sin_init: torch.Tensor
    cos_cover: torch.Tensor  # (B, Lc, D) keys of the tile-aligned cover
    sin_cover: torch.Tensor
    start_tile: torch.Tensor  # (B,) first store tile of the cover
    scalars: torch.Tensor    # (B, 5) int32 kernel scalars: L, start_tile,
                             # total pages, init_active, page_offset


def make_rope_cache(length: torch.Tensor, num_blocks: torch.Tensor, T: int,
                    cfg: ReKVConfig, head_dim: int, rope_base: float,
                    page_offset: Optional[torch.Tensor] = None) -> RopeCache:
    """Everything position-dependent for one append of T tokens.
    length/num_blocks/page_offset: (B,) state BEFORE the append."""
    dev = length.device
    S, Nb, W = cfg.block_size, cfg.max_blocks, n_window_pages(cfg)
    L = length.to(torch.int64)
    offset = (torch.zeros_like(L) if page_offset is None
              else page_offset.to(torch.int64))
    ar = torch.arange(T, device=dev)

    cos_q, sin_q = rope_cos_sin(cfg.n_local + ar, head_dim, rope_base)
    cos_one, sin_one = rope_cos_sin(
        torch.full((), cfg.n_local - 1, device=dev), head_dim, rope_base)
    init_pos = torch.arange(cfg.n_init, device=dev)[None, :]
    rel_init = (init_pos - L[:, None] + cfg.n_local).clamp(
        0, cfg.rope_max_pos - 1)
    cos_init, sin_init = rope_cos_sin(rel_init, head_dim, rope_base)

    n_new = T // S
    total = num_blocks.to(torch.int64) + n_new
    win_start = (total - offset - W).clamp(0, Nb - W)
    ppt = pages_per_tile(S)
    n_read = W // ppt + 1
    start_tile = win_start // ppt
    cover_pages = (offset + start_tile * ppt)[:, None] + torch.arange(
        n_read * ppt, device=dev)[None, :]
    cover_pos = (cfg.n_init + cover_pages[:, :, None] * S
                 + torch.arange(S, device=dev)[None, None, :])
    rel_cover = (cover_pos - L[:, None, None] + cfg.n_local).clamp(
        0, cfg.rope_max_pos - 1)
    cos_cover, sin_cover = rope_cos_sin(rel_cover, head_dim, rope_base)
    B, Lc = L.shape[0], n_read * ppt * S
    cos_cover = cos_cover.reshape(B, Lc, head_dim)
    sin_cover = sin_cover.reshape(B, Lc, head_dim)

    init_active = (L + T) > cfg.n_local
    scalars = torch.stack([L, start_tile, total, init_active.to(torch.int64),
                           offset], dim=1).to(I32)
    return RopeCache(cos_q, sin_q, cos_one, sin_one, cos_init, sin_init,
                     cos_cover, sin_cover, start_tile.to(I32), scalars)


# ---------------------------------------------------------------------------
# Page quantization (kv_quant): the JAX engine's arithmetic, exactly
# ---------------------------------------------------------------------------

def _absmax_scale(x: torch.Tensor, qmax: float) -> torch.Tensor:
    """max(max |x| over the S token rows (axis -2), 1e-8) / qmax in f32,
    correctly rounded on every device: CUDA divides by a Python number
    through its reciprocal, which can land an ulp away, so the divisor is a
    tensor (as Qwen2's weight scales)."""
    a = x.abs().amax(dim=-2).clamp(min=1e-8)
    return a / torch.full_like(a, qmax)


def _quantize_page(x: torch.Tensor):
    """(..., n, S, D) -> (int8 pages, f32 scales (..., n, D)): symmetric
    absmax over the S token rows, half-to-even rounding."""
    xf = x.to(torch.float32)
    scale = _absmax_scale(xf, 127.0)
    q = torch.round(xf / scale[..., None, :])
    return q.clamp(-127, 127).to(torch.int8), scale


def _quantize_page_int4(x: torch.Tensor):
    """(..., n, S, D) -> (uint8 packed nibbles (..., S, D//2), f32 scales
    (..., n, D)): absmax over the S rows onto [-7, 7], packed split-plane
    (byte j holds dim j low, dim j + D/2 high)."""
    xf = x.to(torch.float32)
    scale = _absmax_scale(xf, 7.0)
    q = torch.round(xf / scale[..., None, :])
    return _pack_int4(q.clamp(-7, 7).to(torch.int8)), scale


def _pack_int4(q: torch.Tensor) -> torch.Tensor:
    """int8 nibble values (..., D) in [-8, 7] -> uint8 packed (..., D//2):
    byte j = (q[..., j] & 0xF) | (q[..., j + D/2] << 4)."""
    Dh = q.shape[-1] // 2
    u = q.to(torch.uint8)  # two's complement
    return (u[..., :Dh] & 0x0F) | (u[..., Dh:] << 4)


def _dequant_pages(pages: torch.Tensor, scales: torch.Tensor,
                   dtype) -> torch.Tensor:
    """(..., n, S, D or D//2 packed) int8/uint8 pages x (..., n, D) f32
    scales -> dtype."""
    return dequant_rows(pages, scales[..., :, None, :]).to(dtype)


# ---------------------------------------------------------------------------
# Streaming append (encode path)
# ---------------------------------------------------------------------------

def append_stream(kv: StreamKV, q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor, cfg: ReKVConfig, *, is_init: bool,
                  rope_base: float = 10000.0,
                  rope_cache: Optional[RopeCache] = None,
                  active: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, StreamKV]:
    """One streaming append of T tokens; returns (attn_out, kv) with kv's
    tensors updated in place.

    q: (B, Hq, T, D), k/v: (B, Hkv, T, D), all unrotated.  If is_init the T
    == n_init tokens become the init tokens and attend each other causally.
    Otherwise T is a whole number of pages: they are written to the store
    with one mean key per page, then the queries attend [init tokens |
    window pages | init tokens at the one angle] through stream_attention.
    With kv_quant the pages are quantized on write (the rep keys come from
    the exact keys) and the kernel reads the quantized store.  With
    window_kv_compression the kernel masks the window keys that earlier
    appends dropped (the pages written now keep every row), and each new
    page's keep row becomes its ceil(S/2) tokens of largest mean attention
    output, over heads and dims (top-k ties to the lower token).

    active: optional (B,) bool ragged-ingest mask.  Inactive streams'
    pages, scales, rep keys and counters stay bit-identical (each write
    reads the current content back and writes it again there: the clipped
    slot of a full store lands on live pages); their attention outputs are
    garbage the caller ignores.
    """
    B, Hq, T, D = q.shape
    Hkv = k.shape[1]
    S = cfg.block_size

    if is_init:
        if T != cfg.n_init:
            raise ValueError((T, cfg.n_init))
        rel = cfg.n_local + torch.arange(T, device=q.device)
        q_rot = apply_rope(q, rel, rope_base)
        k_rot = apply_rope(k, rel, rope_base)
        dist = torch.arange(T, device=q.device)[:, None] - torch.arange(
            T, device=q.device)[None, :]
        mask = (dist >= 0) & (dist < cfg.n_local)
        o = multi_stage_attention(q_rot, [AttnStage(k_rot, v,
                                                    mask[None, None])])
        kv.init_k.copy_(k)
        kv.init_v.copy_(v)
        kv.length.add_(T)
        return o, kv

    if T % S:
        raise ValueError(f"append of {T} tokens is not whole {S}-token pages")
    n_new = T // S
    if n_new > cfg.exc_block_size // S:
        raise ValueError(f"append of {n_new} pages exceeds exc_block_size="
                         f"{cfg.exc_block_size} (the window cover is sized "
                         "for it)")
    rc = rope_cache if rope_cache is not None else make_rope_cache(
        kv.length, kv.num_blocks, T, cfg, D, rope_base, kv.page_offset)

    # page + rep-key write, before attention (queries see themselves)
    bidx = torch.arange(B, device=q.device)[:, None]
    ar = torch.arange(n_new, device=q.device)[None, :]
    slot = (kv.num_blocks - kv.page_offset).clamp(0, cfg.max_blocks - n_new)
    pages = slot.to(torch.int64)[:, None] + ar                  # (B, n_new)
    k_pages = k.reshape(B, Hkv, n_new, S, D)
    v_pages = v.reshape(B, Hkv, n_new, S, D)
    def write(store, index, new):
        if active is not None:  # inactive streams keep what they hold
            am = active.reshape((B,) + (1,) * (new.dim() - 1))
            new = torch.where(am, new, store[index])
        store[index] = new

    page_ix = (bidx, slice(None), pages)
    quant = cfg.kv_quant != "none"
    if quant:
        qfn = _quantize_page_int4 if cfg.kv_quant == "int4" else \
            _quantize_page
        (k_w, k_sc), (v_w, v_sc) = qfn(k_pages), qfn(v_pages)
        write(kv.block_k_scale, page_ix, k_sc.transpose(1, 2))
        write(kv.block_v_scale, page_ix, v_sc.transpose(1, 2))
    else:  # round into the store's dtype (the state dtype)
        k_w = k_pages.to(kv.block_k.dtype)
        v_w = v_pages.to(kv.block_v.dtype)
    write(kv.block_k, page_ix, k_w.transpose(1, 2))
    write(kv.block_v, page_ix, v_w.transpose(1, 2))
    rep = k_pages.to(torch.float32).mean(dim=3).transpose(1, 2)  # (B,n,H,D)
    rep_slot = kv.num_blocks.clamp(0, cfg.rep_cap - n_new).to(torch.int64)
    write(kv.block_rep, (bidx, rep_slot[:, None] + ar),
          rep.to(kv.block_rep.dtype))

    # the kernel takes queries in the state dtype (a body computing in f32
    # over a bf16 state narrows here, as the Pallas kernel does); the page
    # store's dtype is int8/uint8 when quantized
    dt = kv.init_k.dtype
    q_rot = rotate(q, rc.cos_q, rc.sin_q).to(dt)
    q_one = rotate(q, rc.cos_one, rc.sin_one).to(dt)
    k_init_rot = rotate(kv.init_k, rc.cos_init[:, None], rc.sin_init[:, None])
    # the pages written now still carry all-ones keep rows (a fresh slot,
    # or one reset or vacated by eviction): the chunk attends itself whole
    compress = cfg.window_kv_compression == "select_top_half"
    o = stream_attention(
        q_rot.contiguous(), q_one.contiguous(), kv.block_k, kv.block_v,
        rc.cos_cover, rc.sin_cover, k_init_rot.contiguous(), kv.init_v,
        kv.init_k, rc.scalars, n_local=cfg.n_local,
        k_scales=kv.block_k_scale if quant else None,
        v_scales=kv.block_v_scale if quant else None,
        page_keep=kv.page_keep if compress else None).to(q.dtype)
    if compress:
        score = o.to(torch.float32).mean(dim=(1, 3)).reshape(B, n_new, S)
        top = topk_lowest(score, -(-S // 2))[1]
        new_keep = torch.zeros((B, n_new, S), dtype=torch.bool,
                               device=q.device).scatter_(2, top, True)
        write(kv.page_keep, (bidx, pages), new_keep)

    if active is None:
        kv.num_blocks.add_(n_new)
        kv.length.add_(T)
    else:
        act = active.to(I32)
        kv.num_blocks.add_(n_new * act)
        kv.length.add_(T * act)
    return o, kv


# ---------------------------------------------------------------------------
# Retrieval (question time)
# ---------------------------------------------------------------------------

def score_block_logits(kv: StreamKV, q: torch.Tensor, cfg: ReKVConfig,
                       q_valid: Optional[torch.Tensor] = None):
    """Mean question query . each block's rep key (GQA-grouped).
    Returns (logits (B, Rc), blk_valid (B, Rc), q_mean (B, Hq, D))."""
    B, Hq, Lq, D = q.shape
    Hkv = kv.block_rep.shape[2]
    Rc = kv.block_rep.shape[1]
    qf = q.to(torch.float32)
    if q_valid is None:
        q_mean = qf.mean(dim=2)
    else:
        w = q_valid.to(torch.float32)[:, None, :, None]
        q_mean = (qf * w).sum(dim=2) / w.sum(dim=2).clamp(min=1.0)
    q_grp = q_mean.reshape(B, Hkv, Hq // Hkv, D).sum(dim=2)
    logits = torch.einsum("bnhd,bhd->bn", kv.block_rep.to(torch.float32),
                          q_grp)
    slot_ids = torch.arange(Rc, device=q.device)[None, :]
    blk_valid = slot_ids < kv.num_blocks[:, None]
    return logits, blk_valid, q_mean


def score_blocks(kv: StreamKV, q: torch.Tensor, cfg: ReKVConfig,
                 q_valid: Optional[torch.Tensor] = None):
    """Top-k blocks over the full rep history: (abs_idx (B, topk) int32
    ascending, exists (B, topk) bool marking selections of real blocks)."""
    B = q.shape[0]
    Rc = kv.block_rep.shape[1]
    cs = cfg.chunk_size
    logits, blk_valid, _ = score_block_logits(kv, q, cfg, q_valid)
    lg = torch.where(blk_valid, logits, 0.0).reshape(B, Rc // cs, cs)
    cnt = blk_valid.reshape(B, Rc // cs, cs).sum(dim=-1)
    chunk_score = torch.where(cnt > 0, lg.sum(dim=-1) / cnt.clamp(min=1),
                              float("-inf"))
    _, chunk_idx = topk_lowest(chunk_score, cfg.topk // cs, dim=1)
    chunk_valid = torch.gather(cnt > 0, 1, chunk_idx)
    sort_key = torch.where(chunk_valid, chunk_idx, Rc // cs + 1)
    chunk_idx = torch.sort(sort_key, dim=1).values
    abs_idx = (chunk_idx[:, :, None] * cs + torch.arange(
        cs, device=q.device)[None, None, :]).reshape(B, cfg.topk).to(I32)
    exists = abs_idx < kv.num_blocks[:, None]
    return abs_idx, exists


def external_blocks(kv: StreamKV, block_indices: torch.Tensor):
    """Externally chosen blocks (B, topk) as (abs_idx int32, exists):
    entries < 0 or >= num_blocks select nothing (stc_tpu's
    retrieve_blocks(block_indices=))."""
    abs_idx = block_indices.to(device=kv.num_blocks.device, dtype=I32)
    exists = (abs_idx >= 0) & (abs_idx < kv.num_blocks[:, None])
    return abs_idx, exists


def retrieve_scored(kv: StreamKV, cfg: ReKVConfig, abs_idx: torch.Tensor,
                    exists: torch.Tensor):
    """Gather the selected device-resident blocks behind the init tokens,
    valid blocks first in ascending order.  Returns (ret_k, ret_v
    (B, Hkv, R, D) unrotated, token_valid (B, R), valid_len (B,) int32)."""
    resident = exists & (abs_idx >= kv.page_offset[:, None])
    order_key = torch.where(resident, abs_idx.to(torch.int64),
                            torch.iinfo(torch.int32).max)
    order = torch.argsort(order_key, dim=1, stable=True)
    abs_sorted = torch.gather(abs_idx, 1, order)
    sel_valid = torch.gather(resident, 1, order)
    slot = (abs_sorted - kv.page_offset[:, None]).clamp(0, cfg.max_blocks - 1)
    return _gather_retrieved(kv, cfg, slot, sel_valid)


def retrieve_blocks(kv: StreamKV, q: torch.Tensor, cfg: ReKVConfig,
                    q_valid: Optional[torch.Tensor] = None):
    """Query-conditioned top-k block retrieval (score_blocks, then
    retrieve_scored); returns retrieve_scored's 4-tuple."""
    abs_idx, exists = score_blocks(kv, q, cfg, q_valid)
    return retrieve_scored(kv, cfg, abs_idx, exists)


def retrieve_blocks_hosttier(kv: StreamKV, cfg: ReKVConfig,
                             abs_idx: torch.Tensor, exists: torch.Tensor,
                             hp_k: torch.Tensor, hp_v: torch.Tensor,
                             hp_ids: torch.Tensor):
    """retrieve_scored over both tiers: device-resident pages come from the
    store, evicted ones from the prefetch table (hp_k/hp_v (B, Hkv, M, S,
    D) in the state dtype, hp_ids (B, M) absolute page ids in any order,
    int32-max padded).  Selected pages in neither tier are reported in
    `missing` and left out; the served ones come first in ascending
    absolute order.  A forward whose every layer served every selection is
    the all-device forward exactly.  Returns (ret_k, ret_v, token_valid,
    valid_len, missing (B, topk))."""
    B = abs_idx.shape[0]
    resident = abs_idx >= kv.page_offset[:, None]
    eq = hp_ids[:, None, :] == abs_idx[:, :, None]             # (B, topk, M)
    found = eq.any(dim=-1) & ~resident
    pos = eq.to(I32).argmax(dim=-1)                             # first match
    served = exists & (resident | found)
    missing = exists & ~resident & ~found
    order_key = torch.where(served, abs_idx.to(torch.int64),
                            torch.iinfo(torch.int32).max)
    order = torch.argsort(order_key, dim=1, stable=True)
    abs_s = torch.gather(abs_idx, 1, order)
    sel_valid = torch.gather(served, 1, order)
    res_s = torch.gather(resident, 1, order)
    pos_s = torch.gather(pos, 1, order)
    slot = (abs_s - kv.page_offset[:, None]).clamp(0, cfg.max_blocks - 1)
    gk, gv = _gather_pages(kv, cfg, slot)
    bidx = torch.arange(B, device=abs_idx.device)[:, None]
    m = res_s[:, :, None, None, None]
    gk = torch.where(m, gk, hp_k[bidx, :, pos_s])
    gv = torch.where(m, gv, hp_v[bidx, :, pos_s])
    return _pack_retrieved(kv, cfg, gk, gv, sel_valid) + (missing,)


def _gather_pages(kv: StreamKV, cfg: ReKVConfig, block_slot):
    """The pages at block_slot (B, topk) as (B, topk, Hkv, S, D) in the
    state dtype, quantized ones dequantized with their scales."""
    B = block_slot.shape[0]
    bidx = torch.arange(B, device=block_slot.device)[:, None]
    slot = block_slot.to(torch.int64)
    gk = kv.block_k[bidx, :, slot]                        # (B,topk,Hkv,S,D)
    gv = kv.block_v[bidx, :, slot]
    if cfg.kv_quant != "none":  # scales gathered at the same slots
        dt = kv.init_k.dtype
        gk = _dequant_pages(gk, kv.block_k_scale[bidx, :, slot], dt)
        gv = _dequant_pages(gv, kv.block_v_scale[bidx, :, slot], dt)
    return gk, gv


def _gather_retrieved(kv: StreamKV, cfg: ReKVConfig, block_slot, sel_valid):
    gk, gv = _gather_pages(kv, cfg, block_slot)
    return _pack_retrieved(kv, cfg, gk, gv, sel_valid)


def _pack_retrieved(kv: StreamKV, cfg: ReKVConfig, gk, gv, sel_valid):
    """Pack gathered (B, topk, Hkv, S, D) pages behind the init tokens."""
    B, _, Hkv, S, D = gk.shape
    gk = gk.transpose(1, 2).reshape(B, Hkv, cfg.topk * S, D)
    gv = gv.transpose(1, 2).reshape(B, Hkv, cfg.topk * S, D)
    ret_k = torch.cat([kv.init_k, gk], dim=2)
    ret_v = torch.cat([kv.init_v, gv], dim=2)
    tok_valid = torch.cat(
        [torch.ones((B, cfg.n_init), dtype=torch.bool, device=gk.device),
         sel_valid.repeat_interleave(S, dim=1)], dim=1)
    valid_len = (cfg.n_init + sel_valid.sum(dim=1) * S).to(I32)
    return ret_k, ret_v, tok_valid, valid_len


def compress_retrieved(kv: StreamKV, cfg: ReKVConfig, ret_k: torch.Tensor,
                       ret_v: torch.Tensor, valid_len: torch.Tensor,
                       generator: Optional[torch.Generator] = None):
    """Retrieved-KV compression: keep half of each retrieved block's tokens
    by the configured filter_tokens_* strategy, scored against the mean of
    the stream's rep keys over its real blocks.

    ret_k/ret_v: (B, Hkv, R, D) with R = n_init + topk * S; returns (ck,
    cv, new_valid_len) with R2 = n_init + topk * (S // 2).  The kept
    indices are sorted, so block order holds and the valid region stays a
    prefix.  filter_tokens_random draws from `generator` (the JAX engine
    folds the stream length into a fixed key; the port cannot give its
    threefry bits)."""
    B, Hkv, R, D = ret_k.shape
    S, nI = cfg.block_size, cfg.n_init
    Rc = kv.block_rep.shape[1]
    blk = torch.arange(Rc, device=ret_k.device)[None, :] < \
        kv.num_blocks[:, None]
    w = blk.to(torch.float32)[:, :, None, None]
    mem = (kv.block_rep.to(torch.float32) * w).sum(dim=1) / w.sum(
        dim=1).clamp(min=1.0)                                  # (B, Hkv, D)
    toks = ret_k[:, :, nI:].transpose(1, 2).reshape(B, R - nI, Hkv * D)
    idx = filter_tokens(cfg.retrieved_kv_compression, toks,
                        mem.reshape(B, Hkv * D), S, generator)
    idx = torch.sort(idx, dim=1).values                     # (B, topk*keep)
    bidx = torch.arange(B, device=ret_k.device)[:, None]
    gk = ret_k[:, :, nI:][bidx, :, idx].transpose(1, 2)
    gv = ret_v[:, :, nI:][bidx, :, idx].transpose(1, 2)
    ck = torch.cat([ret_k[:, :, :nI], gk], dim=2)
    cv = torch.cat([ret_v[:, :, :nI], gv], dim=2)
    new_valid = nI + (valid_len - nI) // S * cfg.retrieved_keep_per_block
    return ck, cv, new_valid.to(I32)


# ---------------------------------------------------------------------------
# QA decode cache (retrieved prefix + prompt + generated tokens)
# ---------------------------------------------------------------------------

def decode_write(dkv: DecodeKV, k: torch.Tensor, v: torch.Tensor, n_tokens,
                 *, rope_base: float = 10000.0, at_start: bool = False,
                 raw_rows: int = 0) -> DecodeKV:
    """Write T tokens at the cursor (slot 0 if at_start), keys rotated at
    their slot; rows below raw_rows stay unrotated.  k/v: (B, Hkv, T, D).
    Writes land in dkv.k / dkv.v in place; returns DecodeKV with the
    advanced cursor (a new tensor)."""
    B, Hkv, T, D = k.shape
    C = dkv.k.shape[2]
    dev = k.device
    start = (torch.zeros((B,), dtype=torch.int64, device=dev) if at_start
             else dkv.cursor.to(torch.int64))
    slot = (start[:, None] + torch.arange(T, device=dev)[None, :]).clamp(
        max=C - 1)
    k_rot = apply_rope(k, slot[:, None, :], rope_base)
    if raw_rows:
        k_rot = torch.where((slot < raw_rows)[:, None, :, None], k, k_rot)
    bidx = torch.arange(B, device=dev)[:, None]
    dkv.k[bidx, :, slot] = k_rot.transpose(1, 2).to(dkv.k.dtype)
    dkv.v[bidx, :, slot] = v.transpose(1, 2).to(dkv.v.dtype)
    # a Python count stays on the host: a tensor made from it would be a
    # host-to-device copy that waits for the device
    n = n_tokens.to(torch.int64) if torch.is_tensor(n_tokens) else n_tokens
    return DecodeKV(k=dkv.k, v=dkv.v, cursor=(start + n).to(I32))


def decode_attend(q: torch.Tensor, q_slots: torch.Tensor, dkv: DecodeKV,
                  cfg: ReKVConfig, *, rope_base: float = 10000.0):
    """Sliding-window attention of fresh queries over the decode cache.

    q: (B, Hq, T, D) unrotated; q_slots: (B, T) AFFINE slots (q_slots[:, t]
    == q_slots[:, 0] + t at every call site) whose keys are already
    written.  Runs decode_attention.  When decode_cap > n_local (static,
    from the config) the cache can outgrow the window and the JAX engine
    adds the complement-window init stage (rekv_attention.py:401-426); no
    kernel computes that stage, there or here, so both engines run the
    plain multi-stage attention on every device in that case.
    """
    B, Hq, T, D = q.shape
    q_rot = apply_rope(q, q_slots[:, None, :], rope_base)
    if cfg.decode_cap <= cfg.n_local:
        o = decode_attention(q_rot.to(dkv.k.dtype).contiguous(), dkv.k,
                             dkv.v, q_slots[:, 0].to(I32).contiguous(),
                             dkv.cursor.contiguous(), n_local=cfg.n_local)
        return o.to(q.dtype)
    C = dkv.k.shape[2]
    nI = cfg.n_init
    dev = q.device
    slot_pos = torch.arange(C, device=dev)[None, :]
    dist = q_slots[:, :, None].to(torch.int64) - slot_pos[:, None, :]
    mask = (dist >= 0) & (dist < cfg.n_local) & (
        slot_pos < dkv.cursor[:, None])[:, None, :]
    init_pos = torch.arange(nI, device=dev)
    cos_i, sin_i = rope_cos_sin(init_pos, D, rope_base)
    k_win = torch.cat([rotate(dkv.k[:, :, :nI], cos_i, sin_i),
                       dkv.k[:, :, nI:]], dim=2)
    cos1, sin1 = rope_cos_sin(torch.tensor(cfg.n_local - 1, device=dev), D,
                              rope_base)
    q_one = rotate(q, cos1, sin1)
    d_init = q_slots[:, :, None].to(torch.int64) - init_pos[None, None, :]
    m2 = (d_init >= cfg.n_local) & (
        init_pos[None, None, :] < dkv.cursor[:, None, None])
    return multi_stage_attention(q_rot, [
        AttnStage(k_win, dkv.v, mask[:, None]),
        AttnStage(dkv.k[:, :, :nI], dkv.v[:, :, :nI], m2[:, None], q=q_one)])
