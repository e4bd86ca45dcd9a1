"""Paged streaming encode attention: the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces the Pallas kernel ``stc_tpu/ops/stream_attention.py::_kernel``
(wrapper ``stream_attention``).  One joint softmax over three key groups of
a video append,

    [init tokens @ window RoPE | window pages | init tokens @ one angle],

with the window pages read in place from the append-only page store
(B, Hkv, Nb, S, D) from page ``start_tile * ppt`` on, RoPE applied to the
keys from the cover tables, affine position masks, and GQA folded into the
query rows.  The kernel is ``csrc/stream_attention.cu``.

Pages come in three kinds, as in the Pallas kernel:
- 1a: the queries' dtype (bfloat16 or float32);
- 1b: int8, with f32 scales (B, Hkv, Nb, D) per page and dim;
- 1c: packed int4 (uint8 (B, Hkv, Nb, S, D/2), split-plane: byte j holds
  dim j in its low nibble and dim j + D/2 in its high one) with f32 scales.
Quantized pages are dequantized in f32 inside the kernel, rotated, and
rounded to the input dtype; values are dequantized and rounded the same way.

Window compression (``ReKVConfig.window_kv_compression``) passes
``page_keep``, a (B, Nb, S) bool mask over the store's page slots: a window
key is masked unless its keep entry is set.  The JAX package runs that
setting only through its plain jnp path (its Pallas kernel reads no keep
masks); here the same kernel reads one byte a key, in both tiles and for
every page kind.  The init groups are never masked.

Bound on the H100: an 8-page append (T 480) over the full 264-page window
at llava-ov-7b heads does ~103 GFLOP of visible (query, key) pairs, 0.104
ms at the dense bf16 tensor-core rate, against ~16 MB of int8 pages:
operations bound the function; a 1-frame append at llava-ov-0.5b heads
needs ~3.2 GFLOP (3.3 us) and ~7.7 MB of bf16 pages (2.3 us).

Design.  bfloat16 queries run two kernels: a pre-pass that dequantizes,
rotates (reading the first half of each f32 cover-table row, the two halves
being equal) and rounds each live window key and value to bf16 once, into
a (2, B, Hkv, Lc, D) scratch, and a FlashAttention-2 style tensor-core
attention (``mma.sync`` m16n8k16 bf16, 64-key tiles copied with cp.async,
double-buffered).  float32 queries run the FP32-FMA
tile, so their score operands stay float32.  Both split each row tile's
KV walk over several blocks (merged by a combine kernel) so a 60-token
append still fills the card; the split follows the tile the library
reports (``_build.tile``).  PERF.md has the card times.

On a CPU tensor the wrapper runs ``stream_attention_ref``; on a CUDA tensor
it launches the kernel or raises.  ``launches`` counts kernel launches by
page kind; ``masked_launches`` counts those of them that read a page_keep
mask.  A launch adds ``stream_attention_flops`` to the FLOPs counts open
(utils/metrics.py), the products the plain version computes.
"""

from __future__ import annotations

import ctypes

import torch

from stc_tpu_torch.kernels import _build
from stc_tpu_torch.ops.rope import rotate
from stc_tpu_torch.utils import metrics

launches = {"float": 0, "int8": 0, "int4": 0}
masked_launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PAGE_KINDS = {torch.int8: "int8", torch.uint8: "int4"}
_PAGE_CODES = {"float": 0, "int8": 1, "int4": 2}


def pages_per_tile(S: int) -> int:
    """Power-of-two pages per cover tile, keeping the tile near 512 keys
    (the engine's window page count is a multiple of it)."""
    return next((d for d in (8, 4, 2, 1) if d * S <= 512), 1)


def stream_attention_flops(B: int, Hq: int, T: int, D: int, Lc: int,
                           n_init: int) -> int:
    """FLOPs of one call as its plain version computes them: the scores
    and P @ V of B * Hq * T queries of width D over the n_init + Lc +
    n_init keys of the three groups, masked keys included, 2 a
    multiply-add (every page kind, with or without page_keep)."""
    return 4 * B * Hq * T * D * (Lc + 2 * n_init)


def page_kind(block_k: torch.Tensor) -> str:
    """'float' (the queries' dtype), 'int8' or 'int4' (packed uint8)."""
    return _PAGE_KINDS.get(block_k.dtype, "float")


def unpack_int4(p: torch.Tensor) -> torch.Tensor:
    """uint8 packed (..., Dp) -> f32 nibble values (..., 2*Dp), split-plane
    order (low nibbles are dims [0, Dp), high nibbles dims [Dp, 2*Dp)),
    each a two's-complement value in [-8, 7]."""
    p32 = p.to(torch.int32)
    lo = p32 & 0x0F
    hi = (p32 >> 4) & 0x0F
    lo = torch.where(lo > 7, lo - 16, lo)
    hi = torch.where(hi > 7, hi - 16, hi)
    return torch.cat([lo, hi], dim=-1).to(torch.float32)


def dequant_rows(x: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """int8 rows (..., D) or packed int4 rows (..., D/2) times their f32
    scales (..., D), in f32."""
    if x.dtype == torch.uint8:
        x = unpack_int4(x)
    return x.to(torch.float32) * scales


def _check(q_rot, q_one, block_k, block_v, cos_cover, sin_cover,
           k_init_rot, v_init, k_init_raw, scalars, k_scales, v_scales,
           page_keep):
    B, _, T, D = q_rot.shape
    Hkv, Nb, S = block_k.shape[1], block_k.shape[2], block_k.shape[3]
    if T % S:
        raise ValueError(f"append of T={T} tokens is not a whole number of "
                         f"{S}-token pages")
    tensors = (q_rot, q_one, k_init_rot, v_init, k_init_raw)
    if q_rot.dtype not in _DTYPES or any(t.dtype != q_rot.dtype
                                         for t in tensors):
        raise ValueError("stream_attention wants q and the init keys in one "
                         "dtype (bfloat16 or float32)")
    kind = page_kind(block_k)
    if block_v.dtype != block_k.dtype or block_v.shape != block_k.shape:
        raise ValueError("block_k and block_v differ in dtype or shape")
    scales = (k_scales, v_scales)
    if kind == "float":
        if block_k.dtype != q_rot.dtype:
            raise ValueError("stream_attention wants float pages in the "
                             "queries' dtype")
        if any(s is not None for s in scales):
            raise ValueError(f"pages of dtype {block_k.dtype} take no scales")
    else:
        Dp = D // 2 if kind == "int4" else D
        if block_k.shape[-1] != Dp:
            raise ValueError(f"{kind} pages want a last dimension of {Dp}, "
                             f"got {block_k.shape[-1]}")
        for s in scales:
            if s is None or s.dtype != torch.float32 or tuple(s.shape) != (
                    B, Hkv, Nb, D):
                raise ValueError(f"{kind} pages want k_scales and v_scales, "
                                 f"each ({B}, {Hkv}, {Nb}, {D}) float32")
    if cos_cover.dtype != torch.float32 or sin_cover.dtype != torch.float32:
        raise ValueError("rope cover tables must be float32")
    if scalars.dtype != torch.int32 or tuple(scalars.shape) != (B, 5):
        raise ValueError("scalars must be (B, 5) int32")
    if page_keep is not None and (page_keep.dtype != torch.bool or tuple(
            page_keep.shape) != (B, Nb, S)):
        raise ValueError(f"page_keep must be ({B}, {Nb}, {S}) bool")
    allt = tensors + (block_k, block_v, cos_cover, sin_cover, scalars) + \
        tuple(t for t in scales + (page_keep,) if t is not None)
    if any(not t.is_contiguous() for t in allt):
        raise ValueError("stream_attention wants contiguous tensors")
    if any(t.device != q_rot.device for t in allt):
        raise ValueError("stream_attention inputs lie on several devices")


def stream_attention(q_rot, q_one, block_k, block_v, cos_cover, sin_cover,
                     k_init_rot, v_init, k_init_raw, scalars, *,
                     n_local: int, k_scales=None, v_scales=None,
                     page_keep=None) -> torch.Tensor:
    """Fused paged encode-path attention.

    q_rot/q_one: (B, Hq, T, D) queries at the window angle / the one angle.
    block_k/block_v: (B, Hkv, Nb, S, D) unrotated page store in q's dtype,
      or int8 (B, Hkv, Nb, S, D), or packed int4 uint8 (B, Hkv, Nb, S, D/2).
    k_scales/v_scales: (B, Hkv, Nb, D) f32, with quantized pages only.
    cos_cover/sin_cover: (B, Lc, D) f32 tables of the page cover, Lc keys
      from local page start_tile * ppt on.  Each row's two halves must be
      equal, as ``rope_cos_sin`` (and so ``engine.make_rope_cache``) makes
      them: with bfloat16 queries the CUDA kernel reads only the first half
      of each row, so tables whose halves differ give another result there
      than the plain version.
    k_init_rot/v_init/k_init_raw: (B, Hkv, n_init, D).
    scalars: (B, 5) int32 [L, start_tile, total_pages, init_active,
      page_offset].
    page_keep: optional (B, Nb, S) bool, contiguous: the window key in row
      o of page slot p (relative to page_offset, as the store) is masked
      unless page_keep[b, p, o].
    Returns (B, Hq, T, D) in q's dtype.
    """
    args = (q_rot, q_one, block_k, block_v, cos_cover, sin_cover,
            k_init_rot, v_init, k_init_raw, scalars)
    _check(*args, k_scales, v_scales, page_keep)
    kw = dict(n_local=n_local, k_scales=k_scales, v_scales=v_scales,
              page_keep=page_keep)
    if q_rot.device.type == "cpu":
        return stream_attention_ref(*args, **kw)
    if q_rot.device.type != "cuda":
        raise RuntimeError(f"no stream_attention for {q_rot.device}")
    return _launch(*args, **kw)


def _launch(q_rot, q_one, block_k, block_v, cos_cover, sin_cover,
            k_init_rot, v_init, k_init_raw, scalars, *, n_local, k_scales,
            v_scales, page_keep):
    lib = _build.load("stream_attention")
    fn = lib.stc_stream_attention
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 14 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    B, Hq, T, D = q_rot.shape
    Hkv, Nb, S = block_k.shape[1], block_k.shape[2], block_k.shape[3]
    Lc, n_init = cos_cover.shape[1], k_init_rot.shape[2]
    kind = page_kind(block_k)
    codes = (_DTYPES[q_rot.dtype], _PAGE_CODES[kind], D)
    n_split = _build.n_splits("stream_attention", codes, (Hq // Hkv) * T,
                              Hkv * B, Lc, q_rot.device)
    rows = B * Hq * T
    dev = q_rot.device
    part_acc = torch.empty((n_split, rows, D), dtype=torch.float32,
                           device=dev)
    part_ml = torch.empty((n_split, rows, 2), dtype=torch.float32, device=dev)
    # the bf16 kernel's rotated, dequantized window keys and values
    cover = (torch.empty((2, B, Hkv, Lc, D), dtype=torch.bfloat16,
                         device=dev) if q_rot.dtype == torch.bfloat16
             else None)
    out = torch.empty_like(q_rot)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(q_rot.data_ptr(), q_one.data_ptr(), block_k.data_ptr(),
            block_v.data_ptr(),
            None if k_scales is None else k_scales.data_ptr(),
            None if v_scales is None else v_scales.data_ptr(),
            cos_cover.data_ptr(), sin_cover.data_ptr(),
            k_init_rot.data_ptr(), v_init.data_ptr(), k_init_raw.data_ptr(),
            scalars.data_ptr(),
            None if page_keep is None else page_keep.data_ptr(),
            part_acc.data_ptr(), part_ml.data_ptr(),
            None if cover is None else cover[0].data_ptr(),
            None if cover is None else cover[1].data_ptr(),
            out.data_ptr(), B, Hq, Hkv, T, D, Nb, S, Lc, pages_per_tile(S),
            n_init, n_local, n_split, _DTYPES[q_rot.dtype],
            _PAGE_CODES[kind], stream)
    _build.check_launch(rc, "stream_attention")
    launches[kind] += 1
    metrics.add_kernel_flops(stream_attention_flops(B, Hq, T, D, Lc, n_init))
    if page_keep is not None:
        global masked_launches
        masked_launches += 1
    return out


def stream_attention_ref(q_rot, q_one, block_k, block_v, cos_cover,
                         sin_cover, k_init_rot, v_init, k_init_raw, scalars,
                         *, n_local: int, k_scales=None, v_scales=None,
                         page_keep=None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: one full softmax over
    [init-local | page cover | init-far] (the three-group joint softmax of
    the JAX engine's _stream_attention), with the kernel's rounding points:
    quantized pages dequantized in f32, rotated keys (and dequantized
    values) in the input dtype, probabilities rounded to the value dtype
    before P @ V, output normalised by the unrounded sum (0 where no key is
    visible).  page_keep ANDs the window pages' keep rows into the window
    group's mask (the JAX engine's jnp path)."""
    B, Hq, T, D = q_rot.shape
    Hkv, Nb, S = block_k.shape[1], block_k.shape[2], block_k.shape[3]
    G = Hq // Hkv
    Lc, n_init = cos_cover.shape[1], k_init_rot.shape[2]
    dev, dt, f32 = q_rot.device, q_rot.dtype, torch.float32
    sc = scalars.to(torch.int64)
    L, start_tile, total, init_active, offset = sc.unbind(1)

    c = torch.arange(Lc, device=dev)
    page = (start_tile * pages_per_tile(S))[:, None] + c // S   # (B, Lc)
    in_store = page < Nb
    bidx = torch.arange(B, device=dev)[:, None]
    pg = page.clamp(max=Nb - 1)
    k_win = block_k[bidx, :, pg, c % S]                   # (B, Lc, H, D|Dp)
    v_win = block_v[bidx, :, pg, c % S]
    if k_scales is None:
        k_win, v_win = k_win.to(f32), v_win.to(f32)
    else:
        k_win = dequant_rows(k_win, k_scales[bidx, :, pg])
        v_win = dequant_rows(v_win, v_scales[bidx, :, pg])
    k_win = rotate(k_win.transpose(1, 2), cos_cover[:, None],
                   sin_cover[:, None]).to(dt)                   # (B,H,Lc,D)
    v_win = v_win.transpose(1, 2).to(dt)
    abs_page = page + offset[:, None]
    pos = n_init + abs_page * S + c % S                         # (B, Lc)
    key_ok = in_store & (abs_page < total[:, None])
    if page_keep is not None:
        key_ok = key_ok & page_keep[bidx, pg, c % S]

    q_pos = L[:, None] + torch.arange(T, device=dev)            # (B, T)
    dist = q_pos[:, :, None] - pos[:, None, :]
    m_win = key_ok[:, None, :] & (dist >= 0) & (dist < n_local)
    j = torch.arange(n_init, device=dev)
    d_i = q_pos[:, :, None] - j
    m_init = (d_i >= 0) & (d_i < n_local)
    m_far = (init_active > 0)[:, None, None].expand(B, T, n_init)
    mask = torch.cat([m_init, m_win, m_far], dim=-1)[:, None, None]

    def scores(q, k):
        qg = q.reshape(B, Hkv, G, T, D).to(f32)
        return torch.einsum("bhgqd,bhkd->bhgqk", qg, k.to(f32))

    s = torch.cat([scores(q_rot, k_init_rot), scores(q_rot, k_win),
                   scores(q_one, k_init_raw)], dim=-1) * (1.0 / D ** 0.5)
    s = torch.where(mask, s, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - torch.where(torch.isfinite(m), m, 0.0))
    l = p.sum(dim=-1, keepdim=True)
    v_all = torch.cat([v_init, v_win, v_init], dim=2).to(f32)
    acc = torch.einsum("bhgqk,bhkd->bhgqd", p.to(v_init.dtype).to(f32), v_all)
    o = acc / torch.where(l == 0, 1.0, l)
    return o.reshape(B, Hq, T, D).to(dt)
