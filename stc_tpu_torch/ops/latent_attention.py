"""Paged streaming encode attention over latent rows (multi-head latent
attention, absorbed): the CUDA kernel's wrapper and its plain PyTorch
version.

The store of a latent-attention LM (DeepSeek-V3's MLA, ``models/
deepseek_v3.py``) keeps one row a token and layer, ``[c (R) | k_pe (P)]``:
the normed compressed KV (R = kv_lora_rank, 512) and the rope part of the
key (P = qk_rope_head_dim, 64), unrotated.  Every query head attends that
one row: the absorbed query ``[q_nope W_UK (R) | q_pe (P)]`` scores the
whole W = R + P wide row, and the head's value is the row's first R dims.
So the call is ``stream_attention``'s joint softmax over

    [init rows @ window RoPE | window pages | init rows @ one angle]

with one latent head shared by every query head, keys W wide of which only
the last P dims are rotated (rotate-half within them), values the first R
dims of the same rows, and the output (B, T, Hq, R).  Positions, the page
cover, the affine masks and the kernel scalars are ``stream_attention``'s
(``engine.make_rope_cache`` at head_dim P).  The scale is the model's
(1 / sqrt(qk_nope_head_dim + qk_rope_head_dim)), not 1 / sqrt(W).

The kernel is ``csrc/latent_attention.cu`` (bfloat16 only): a pre-pass
rotates the rope dims of the window cover once, then tiles of 32 keys
over 16 query rows a warp pair, split over the keys with a combine
kernel.  On a CPU tensor the wrapper runs ``latent_attention_ref``; on a
CUDA tensor it launches the kernel or raises.  ``launches`` counts
kernel launches; a launch adds ``latent_attention_flops`` to the FLOPs
counts open (utils/metrics.py).  Launches a CUDA graph replays are
counted with ``add_launches`` (runtime/graphs.py).
"""

from __future__ import annotations

import torch

from stc_tpu_torch.kernels import _build
from stc_tpu_torch.ops.rope import rotate
from stc_tpu_torch.ops.stream_attention import pages_per_tile
from stc_tpu_torch.utils import metrics

launches = 0

# the shapes the kernel is built for: W-wide rows, P rope dims
WIDTH, ROPE = 576, 64


def add_launches(n: int) -> None:
    """Add launches that did not pass the wrapper (a graph replay's)."""
    global launches
    launches += n


def latent_attention_flops(B: int, Hq: int, T: int, W: int, R: int, Lc: int,
                           n_init: int) -> int:
    """The products of one call as its plain version computes them: scores
    over W dims and P @ V over R dims of B * Hq * T queries against the
    n_init + Lc + n_init keys of the three groups, masked keys included, 2
    a multiply-add."""
    return 2 * B * Hq * T * (W + R) * (Lc + 2 * n_init)


def _check(q_rot, q_one, block_c, cos_cover, sin_cover, k_init_rot,
           k_init_raw, scalars):
    B, T, Hq, W = q_rot.shape
    Nb, S = block_c.shape[1], block_c.shape[2]
    P = cos_cover.shape[-1]
    if T % S:
        raise ValueError(f"append of T={T} tokens is not a whole number of "
                         f"{S}-token pages")
    if tuple(q_one.shape) != tuple(q_rot.shape) or block_c.shape[-1] != W \
            or k_init_rot.shape[-1] != W or k_init_raw.shape != \
            k_init_rot.shape or P % 2 or P >= W:
        raise ValueError("latent_attention wants queries, pages and init "
                         "rows of one width W, and P < W even rope dims")
    tensors = (q_rot, q_one, block_c, k_init_rot, k_init_raw)
    if any(t.dtype != q_rot.dtype for t in tensors) or q_rot.dtype not in (
            torch.float32, torch.bfloat16):
        raise ValueError("latent_attention wants queries, pages and init "
                         "rows in one dtype (bfloat16 or float32)")
    if cos_cover.dtype != torch.float32 or sin_cover.dtype != torch.float32:
        raise ValueError("rope cover tables must be float32")
    if scalars.dtype != torch.int32 or tuple(scalars.shape) != (B, 5):
        raise ValueError("scalars must be (B, 5) int32")
    allt = tensors + (cos_cover, sin_cover, scalars)
    if any(not t.is_contiguous() for t in allt):
        raise ValueError("latent_attention wants contiguous tensors")
    if any(t.device != q_rot.device for t in allt):
        raise ValueError("latent_attention inputs lie on several devices")


def latent_attention(q_rot, q_one, block_c, cos_cover, sin_cover, k_init_rot,
                     k_init_raw, scalars, *, n_local: int,
                     scale: float) -> torch.Tensor:
    """Fused paged encode-path attention over latent rows.

    q_rot/q_one: (B, T, Hq, W) absorbed queries, their last P dims rotated
      at the window angle / the one angle.
    block_c: (B, Nb, S, W) the page store of latent rows, unrotated.
    cos_cover/sin_cover: (B, Lc, P) f32 tables of the page cover (each
      row's two halves equal, as ``rope_cos_sin`` makes them), Lc rows
      from local page start_tile * ppt on.
    k_init_rot/k_init_raw: (B, n_init, W) the init rows, the last P dims
      rotated to the window / as stored.
    scalars: (B, 5) int32 [L, start_tile, total_pages, init_active,
      page_offset] (stream_attention's).
    Returns (B, T, Hq, W - P) in q's dtype.
    """
    args = (q_rot, q_one, block_c, cos_cover, sin_cover, k_init_rot,
            k_init_raw, scalars)
    _check(*args)
    if q_rot.device.type == "cpu":
        return latent_attention_ref(*args, n_local=n_local, scale=scale)
    if q_rot.device.type != "cuda":
        raise RuntimeError(f"no latent_attention for {q_rot.device}")
    return _launch(*args, n_local=n_local, scale=scale)


def _launch(q_rot, q_one, block_c, cos_cover, sin_cover, k_init_rot,
            k_init_raw, scalars, *, n_local, scale):
    B, T, Hq, W = q_rot.shape
    Nb, S = block_c.shape[1], block_c.shape[2]
    Lc, P = cos_cover.shape[1], cos_cover.shape[2]
    n_init = k_init_rot.shape[1]
    if q_rot.dtype != torch.bfloat16 or (W, P) != (WIDTH, ROPE):
        raise ValueError(f"the latent_attention kernel is built for "
                         f"bfloat16 rows of {WIDTH} dims, {ROPE} of them "
                         f"rotated; got {q_rot.dtype} rows of {W} ({P})")
    fn = _build.entry("latent_attention")
    dev = q_rot.device
    R = W - P
    rows = Hq * T
    n_split = _build.n_splits("latent_attention", (), rows, B,
                              Lc + 2 * 32, dev)
    part_acc = torch.empty((n_split, B * rows, R), dtype=torch.float32,
                           device=dev)
    part_ml = torch.empty((n_split, B * rows, 2), dtype=torch.float32,
                          device=dev)
    out = torch.empty((B, T, Hq, R), dtype=q_rot.dtype, device=dev)
    rope = torch.empty((B, Lc, P), dtype=q_rot.dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(q_rot.data_ptr(), q_one.data_ptr(), block_c.data_ptr(),
            cos_cover.data_ptr(), sin_cover.data_ptr(),
            k_init_rot.data_ptr(), k_init_raw.data_ptr(), scalars.data_ptr(),
            rope.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(),
            out.data_ptr(),
            B, Hq, T, Nb, S, Lc, pages_per_tile(S), n_init, n_local,
            n_split, float(scale), stream)
    _build.check_launch(rc, "latent_attention")
    global launches
    launches += 1
    metrics.add_kernel_flops(latent_attention_flops(B, Hq, T, W, R, Lc,
                                                    n_init))
    return out


def latent_attention_ref(q_rot, q_one, block_c, cos_cover, sin_cover,
                         k_init_rot, k_init_raw, scalars, *, n_local: int,
                         scale: float) -> torch.Tensor:
    """Plain PyTorch version of the kernel: one softmax over [init @ window
    RoPE | page cover | init @ one angle], at the kernel's rounding points:
    each window row's rope dims rotated in f32 and rounded to the input
    dtype, scores in f32, probabilities rounded to the input dtype before
    P @ V, the output normalised by the unrounded sum (0 where no key is
    visible)."""
    B, T, Hq, W = q_rot.shape
    Nb, S = block_c.shape[1], block_c.shape[2]
    Lc, P = cos_cover.shape[1], cos_cover.shape[2]
    R = W - P
    n_init = k_init_rot.shape[1]
    dev, dt, f32 = q_rot.device, q_rot.dtype, torch.float32
    L, start_tile, total, init_active, offset = scalars.to(
        torch.int64).unbind(1)

    c = torch.arange(Lc, device=dev)
    page = (start_tile * pages_per_tile(S))[:, None] + c // S   # (B, Lc)
    in_store = page < Nb
    bidx = torch.arange(B, device=dev)[:, None]
    win = block_c[bidx, page.clamp(max=Nb - 1), c % S]          # (B, Lc, W)
    win = torch.cat([win[..., :R], rotate(win[..., R:], cos_cover,
                                          sin_cover)], dim=-1).to(dt)
    abs_page = page + offset[:, None]
    pos = n_init + abs_page * S + c % S
    key_ok = in_store & (abs_page < total[:, None])

    q_pos = L[:, None] + torch.arange(T, device=dev)            # (B, T)
    dist = q_pos[:, :, None] - pos[:, None, :]
    m_win = key_ok[:, None, :] & (dist >= 0) & (dist < n_local)
    d_i = q_pos[:, :, None] - torch.arange(n_init, device=dev)
    m_init = (d_i >= 0) & (d_i < n_local)
    m_far = (init_active > 0)[:, None, None].expand(B, T, n_init)
    mask = torch.cat([m_init, m_win, m_far], dim=-1)[:, :, None]

    def scores(q, k):
        return torch.einsum("bthw,bkw->bthk", q.to(f32), k.to(f32))

    s = torch.cat([scores(q_rot, k_init_rot), scores(q_rot, win),
                   scores(q_one, k_init_raw)], dim=-1) * scale
    s = torch.where(mask, s, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - torch.where(torch.isfinite(m), m, 0.0))
    l = p.sum(dim=-1, keepdim=True)
    v = torch.cat([k_init_raw, win, k_init_raw], dim=1)[..., :R].to(f32)
    acc = torch.einsum("bthk,bkr->bthr", p.to(dt).to(f32), v)
    return (acc / torch.where(l == 0, 1.0, l)).to(dt)
