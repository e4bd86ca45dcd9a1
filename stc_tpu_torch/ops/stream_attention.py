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

Bound on the H100: a 1-frame append over the full llava-ov-0.5b window
needs ~3.2 GFLOP (3.3 us at the bf16 tensor-core rate) and ~7.7 MB of page
reads (2.3 us at 3.35 TB/s), so operations bound the function.  This
design also reads the f32 RoPE cover tables (another ~7.7 MB, 4.7 us in
all), which computing the angles from the affine key positions in the
kernel would save.  It runs the tile products as FP32 FMA out of shared
memory and splits each row tile's KV walk over several blocks (merged by a
combine kernel) so a 60-token append still fills the card; it does not use
tensor cores or TMA (PERF.md has its distance from the bound).

On a CPU tensor the wrapper runs ``stream_attention_ref``; on a CUDA tensor
it launches the kernel or raises.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from stc_tpu_torch.kernels import _build
from stc_tpu_torch.ops.rope import rotate

launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def pages_per_tile(S: int) -> int:
    """Power-of-two pages per cover tile, keeping the tile near 512 keys
    (the engine's window page count is a multiple of it)."""
    return next((d for d in (8, 4, 2, 1) if d * S <= 512), 1)


def _check(q_rot, q_one, block_k, block_v, cos_cover, sin_cover,
           k_init_rot, v_init, k_init_raw, scalars):
    T, S = q_rot.shape[2], block_k.shape[3]
    if T % S:
        raise ValueError(f"append of T={T} tokens is not a whole number of "
                         f"{S}-token pages")
    if block_k.dtype not in _DTYPES:
        raise NotImplementedError(
            f"pages of dtype {block_k.dtype}: quantized pages are not ported "
            "yet (ROADMAP.md queue 2, stream_attention 1b/1c)")
    tensors = (q_rot, q_one, block_k, block_v, k_init_rot, v_init, k_init_raw)
    if any(t.dtype != q_rot.dtype for t in tensors):
        raise ValueError("stream_attention wants q, pages and init keys in "
                         "one dtype (bfloat16 or float32)")
    if cos_cover.dtype != torch.float32 or sin_cover.dtype != torch.float32:
        raise ValueError("rope cover tables must be float32")
    if scalars.dtype != torch.int32 or tuple(scalars.shape) != (
            q_rot.shape[0], 5):
        raise ValueError("scalars must be (B, 5) int32")
    allt = tensors + (cos_cover, sin_cover, scalars)
    if any(not t.is_contiguous() for t in allt):
        raise ValueError("stream_attention wants contiguous tensors")
    if any(t.device != q_rot.device for t in allt):
        raise ValueError("stream_attention inputs lie on several devices")


def stream_attention(q_rot, q_one, block_k, block_v, cos_cover, sin_cover,
                     k_init_rot, v_init, k_init_raw, scalars, *,
                     n_local: int) -> torch.Tensor:
    """Fused paged encode-path attention.

    q_rot/q_one: (B, Hq, T, D) queries at the window angle / the one angle.
    block_k/block_v: (B, Hkv, Nb, S, D) unrotated page store.
    cos_cover/sin_cover: (B, Lc, D) f32 tables of the page cover, Lc keys
      from local page start_tile * ppt on.
    k_init_rot/v_init/k_init_raw: (B, Hkv, n_init, D).
    scalars: (B, 5) int32 [L, start_tile, total_pages, init_active,
      page_offset].  Returns (B, Hq, T, D) in q's dtype.
    """
    args = (q_rot, q_one, block_k, block_v, cos_cover, sin_cover,
            k_init_rot, v_init, k_init_raw, scalars)
    _check(*args)
    if q_rot.device.type == "cpu":
        return stream_attention_ref(*args, n_local=n_local)
    if q_rot.device.type != "cuda":
        raise RuntimeError(f"no stream_attention for {q_rot.device}")
    return _launch(*args, n_local=n_local)


def _launch(q_rot, q_one, block_k, block_v, cos_cover, sin_cover,
            k_init_rot, v_init, k_init_raw, scalars, *, n_local):
    global launches
    lib = _build.load("stream_attention")
    fn = lib.stc_stream_attention
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 13 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    B, Hq, T, D = q_rot.shape
    Hkv, Nb, S = block_k.shape[1], block_k.shape[2], block_k.shape[3]
    Lc, n_init = cos_cover.shape[1], k_init_rot.shape[2]
    row_blocks = -(-(Hq // Hkv) * T // 64) * Hkv * B
    n_split = _build.n_splits(row_blocks, -(-Lc // 64), q_rot.device)
    rows = B * Hq * T
    dev = q_rot.device
    part_acc = torch.empty((n_split, rows, D), dtype=torch.float32,
                           device=dev)
    part_ml = torch.empty((n_split, rows, 2), dtype=torch.float32, device=dev)
    out = torch.empty_like(q_rot)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(q_rot.data_ptr(), q_one.data_ptr(), block_k.data_ptr(),
            block_v.data_ptr(), cos_cover.data_ptr(), sin_cover.data_ptr(),
            k_init_rot.data_ptr(), v_init.data_ptr(), k_init_raw.data_ptr(),
            scalars.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(),
            out.data_ptr(), B, Hq, Hkv, T, D, Nb, S, Lc, pages_per_tile(S),
            n_init, n_local, n_split, _DTYPES[q_rot.dtype], stream)
    _build.check_launch(rc, "stream_attention")
    launches += 1
    return out


def stream_attention_ref(q_rot, q_one, block_k, block_v, cos_cover,
                         sin_cover, k_init_rot, v_init, k_init_raw, scalars,
                         *, n_local: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: one full softmax over
    [init-local | page cover | init-far] (the three-group joint softmax of
    the JAX engine's _stream_attention), with the kernel's rounding points:
    rotated keys in the input dtype, probabilities rounded to the value
    dtype before P @ V, output normalised by the unrounded sum (0 where no
    key is visible)."""
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
    k_win = block_k[bidx, :, page.clamp(max=Nb - 1), c % S]     # (B,Lc,H,D)
    v_win = block_v[bidx, :, page.clamp(max=Nb - 1), c % S]
    k_win = rotate(k_win.transpose(1, 2), cos_cover[:, None],
                   sin_cover[:, None])                          # (B,H,Lc,D)
    v_win = v_win.transpose(1, 2)
    abs_page = page + offset[:, None]
    pos = n_init + abs_page * S + c % S                         # (B, Lc)
    key_ok = in_store & (abs_page < total[:, None])

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
