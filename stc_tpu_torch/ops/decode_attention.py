"""Sliding-window attention over the QA decode cache and its per-key
attention mass: the CUDA kernels' wrappers and their plain PyTorch versions.

``decode_attention`` replaces the Pallas kernel
``stc_tpu/ops/decode_attention.py::_attn_kernel``: T fresh queries at
affine slots ``start + t`` attend the decode cache (B, Hkv, C, D), whose
keys are stored already rotated, under the mask ``0 <= q_slot - slot <
n_local`` and ``slot < cursor``; GQA is folded into the query rows.  With
``return_m`` the row maxima of the scaled, masked scores come back too.
The kernel is ``csrc/decode_attention.cu``.

``decode_score`` replaces ``_score_kernel``: under the same mask, the mass
``sum_t exp(s_tk * scale - m_t)`` each key receives from the queries of
each query head, not normalised by the softmax sum (the reference's
get_score), with m from ``decode_attention(return_m=True)``.  The kernel is
``csrc/decode_score.cu``.  No session path calls it.

Bound on the H100: a token step at llava-ov-0.5b shapes reads ~2 MB of
live cache (0.6 us at 3.35 TB/s), below the cost of a launch; the
256-token prompt prefill is bound by its bf16 products (~15 us at 7B
heads); at 0.5b heads its exponentials (one per visible query-key pair
and head, 16 a clock per SM against 4096 flops) tie them, ~3.7 us each,
since at D = 64 a pair costs 4 D = 256 flops.  decode_score pays the same
exponentials for only half the products, so they bound it: ~3.7 us at
0.5b heads (its products ~1.9 us).
decode_attention splits the live slot range over blocks (flash-decoding,
with a combine kernel) so one kv head's 7 query rows still spread over the
card; bfloat16 queries run the tensor-core tile (``mma.sync``, 64-slot
tiles copied with cp.async, double-buffered),
float32 ones the FP32-FMA tile, and the split follows the tile the
library reports.  decode_score gives each block one key tile of one query
head, so its sums need no second pass; bfloat16 runs it on tensor cores
with the keys as the MMA rows and the queries streamed past them, float32
on the FP32-FMA tile (PERF.md has the distance from the bound).

On a CPU tensor a wrapper runs its plain version; on a CUDA tensor it
launches the kernel or raises.  ``launches`` counts decode_attention's
kernel launches, ``score_launches`` decode_score's.
"""

from __future__ import annotations

import ctypes

import torch

from stc_tpu_torch.kernels import _build

launches = 0
score_launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(q_rot, k, v, start, cursor):
    if q_rot.dtype not in _DTYPES or k.dtype != q_rot.dtype \
            or v.dtype != q_rot.dtype:
        raise ValueError("decode_attention wants q, k and v in one dtype "
                         "(bfloat16 or float32)")
    B = q_rot.shape[0]
    for t in (start, cursor):
        if t.dtype != torch.int32 or tuple(t.shape) != (B,):
            raise ValueError("start and cursor must be (B,) int32")
    allt = (q_rot, k, v, start, cursor)
    if any(not t.is_contiguous() for t in allt):
        raise ValueError("decode_attention wants contiguous tensors")
    if any(t.device != q_rot.device for t in allt):
        raise ValueError("decode_attention inputs lie on several devices")


def decode_attention(q_rot, k, v, start, cursor, *, n_local: int,
                     return_m: bool = False):
    """q_rot: (B, Hq, T, D) queries rotated at slots start..start+T-1;
    k/v: (B, Hkv, C, D) rotated decode cache; start/cursor: (B,) int32.
    Returns (B, Hq, T, D), plus row maxima (B, Hq, T) f32 with return_m
    (-inf on a row that sees no key)."""
    _check(q_rot, k, v, start, cursor)
    if q_rot.device.type == "cpu":
        return decode_attention_ref(q_rot, k, v, start, cursor,
                                    n_local=n_local, return_m=return_m)
    if q_rot.device.type != "cuda":
        raise RuntimeError(f"no decode_attention for {q_rot.device}")
    return _launch(q_rot, k, v, start, cursor, n_local, return_m)


def _launch(q_rot, k, v, start, cursor, n_local, return_m):
    global launches
    lib = _build.load("decode_attention")
    fn = lib.stc_decode_attention
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    B, Hq, T, D = q_rot.shape
    Hkv, C = k.shape[1], k.shape[2]
    dev = q_rot.device
    n_split = _build.n_splits("decode_attention", (_DTYPES[q_rot.dtype], D),
                              (Hq // Hkv) * T, Hkv * B, C, dev)
    rows = B * Hq * T
    part_acc = torch.empty((n_split, rows, D), dtype=torch.float32,
                           device=dev)
    part_ml = torch.empty((n_split, rows, 2), dtype=torch.float32, device=dev)
    out = torch.empty_like(q_rot)
    m = (torch.empty((B, Hq, T), dtype=torch.float32, device=dev)
         if return_m else None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(q_rot.data_ptr(), k.data_ptr(), v.data_ptr(), start.data_ptr(),
            cursor.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(),
            out.data_ptr(), None if m is None else m.data_ptr(), B, Hq, Hkv,
            T, D, C, n_local, n_split, _DTYPES[q_rot.dtype], stream)
    _build.check_launch(rc, "decode_attention")
    launches += 1
    return (out, m) if return_m else out


def decode_attention_ref(q_rot, k, v, start, cursor, *, n_local: int,
                         return_m: bool = False):
    """Plain PyTorch version of the kernel: one masked softmax in float32,
    probabilities rounded to the value dtype before P @ V, output normalised
    by the unrounded sum (0 where no key is visible)."""
    B, Hq, T, D = q_rot.shape
    Hkv, C = k.shape[1], k.shape[2]
    G = Hq // Hkv
    dev, f32 = q_rot.device, torch.float32
    qg = q_rot.reshape(B, Hkv, G, T, D).to(f32)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.to(f32)) * (1.0 / D ** 0.5)
    slot = torch.arange(C, device=dev)
    q_slot = start.to(torch.int64)[:, None] + torch.arange(T, device=dev)
    dist = q_slot[:, :, None] - slot
    mask = (dist >= 0) & (dist < n_local) & (
        slot < cursor.to(torch.int64)[:, None, None])
    s = torch.where(mask[:, None, None], s, float("-inf"))
    m = s.amax(dim=-1)
    p = torch.exp(s - torch.where(torch.isfinite(m), m, 0.0)[..., None])
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhgqk,bhkd->bhgqd", p.to(v.dtype).to(f32), v.to(f32))
    o = (acc / torch.where(l == 0, 1.0, l)).reshape(B, Hq, T, D)
    o = o.to(q_rot.dtype)
    return (o, m.reshape(B, Hq, T)) if return_m else o


def _check_score(q_rot, k, m, start, cursor):
    if q_rot.dtype not in _DTYPES or k.dtype != q_rot.dtype:
        raise ValueError("decode_score wants q and k in one dtype "
                         "(bfloat16 or float32)")
    B, Hq, T, _ = q_rot.shape
    if m.dtype != torch.float32 or tuple(m.shape) != (B, Hq, T):
        raise ValueError(f"m must be ({B}, {Hq}, {T}) float32")
    for t in (start, cursor):
        if t.dtype != torch.int32 or tuple(t.shape) != (B,):
            raise ValueError("start and cursor must be (B,) int32")
    allt = (q_rot, k, m, start, cursor)
    if any(not t.is_contiguous() for t in allt):
        raise ValueError("decode_score wants contiguous tensors")
    if any(t.device != q_rot.device for t in allt):
        raise ValueError("decode_score inputs lie on several devices")


def decode_score(q_rot, k, m, start, cursor, *, n_local: int):
    """Per-key attention mass over the decode cache.
    q_rot: (B, Hq, T, D) queries rotated at slots start..start+T-1;
    k: (B, Hkv, C, D) rotated decode keys; m: (B, Hq, T) f32 row maxima from
    decode_attention(return_m=True); start/cursor: (B,) int32.
    Returns (B, Hq, C) f32."""
    _check_score(q_rot, k, m, start, cursor)
    if q_rot.device.type == "cpu":
        return decode_score_ref(q_rot, k, m, start, cursor, n_local=n_local)
    if q_rot.device.type != "cuda":
        raise RuntimeError(f"no decode_score for {q_rot.device}")
    return _launch_score(q_rot, k, m, start, cursor, n_local)


def _launch_score(q_rot, k, m, start, cursor, n_local):
    global score_launches
    lib = _build.load("decode_score")
    fn = lib.stc_decode_score
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    B, Hq, T, D = q_rot.shape
    Hkv, C = k.shape[1], k.shape[2]
    out = torch.empty((B, Hq, C), dtype=torch.float32, device=q_rot.device)
    stream = torch.cuda.current_stream(q_rot.device).cuda_stream
    rc = fn(q_rot.data_ptr(), k.data_ptr(), m.data_ptr(), start.data_ptr(),
            cursor.data_ptr(), out.data_ptr(), B, Hq, Hkv, T, D, C, n_local,
            _DTYPES[q_rot.dtype], stream)
    _build.check_launch(rc, "decode_score")
    score_launches += 1
    return out


def decode_score_ref(q_rot, k, m, start, cursor, *, n_local: int):
    """Plain PyTorch version of the kernel (the JAX package's
    decode_score_jnp): f32 scores of the input-dtype operands, masked
    terms selected to 0."""
    B, Hq, T, D = q_rot.shape
    Hkv, C = k.shape[1], k.shape[2]
    G = Hq // Hkv
    dev, f32 = q_rot.device, torch.float32
    qg = q_rot.reshape(B, Hkv, G, T, D).to(f32)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.to(f32))
    s = s.reshape(B, Hq, T, C) * (1.0 / D ** 0.5)
    slot = torch.arange(C, device=dev)
    q_slot = start.to(torch.int64)[:, None] + torch.arange(T, device=dev)
    dist = q_slot[:, :, None] - slot
    mask = (dist >= 0) & (dist < n_local) & (
        slot < cursor.to(torch.int64)[:, None, None])
    p = torch.where(mask[:, None], torch.exp(s - m[..., None]), 0.0)
    return p.sum(dim=2)
