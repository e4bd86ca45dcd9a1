"""The yardstick's arithmetic: the H100's published peaks, the products,
bytes and exponentials of the port's kernel calls, chunks and questions as
functions of their shapes, and the statistics of a window.

Peaks (NVIDIA H100 SXM data sheet, dense, at the 700 W limit): 989 TFLOP/s
bf16 on the tensor cores (132 SMs x 4096 a clock at 1830 MHz), 67 TFLOP/s
float32 outside them, 3.35 TB/s of HBM3, and exponentials at 132 SMs x 16
a clock at the same 1830 MHz.

Counting rules: a product of an (m, k) by a (k, n) matrix is 2 m k n
operations; attention counts only the (query, key) pairs its masks let
through, 4 D operations and one exponential a pair and head; bytes count
each input once and each output once (weights read once a pass, pages
read once a call), however often a kernel reads them again.  The least
time of a piece of work is the largest of its bytes over the memory rate,
its products over their peaks (bf16 and float32 terms added) and its
exponentials over their rate.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

BF16_FLOPS = 132 * 4096 * 1.83e9   # 989 TFLOP/s
F32_FLOPS = 67e12
HBM_BYTES = 3.35e12
EXPS = 132 * 16 * 1.83e9


@dataclass
class Work:
    """Products (by dtype), bytes and exponentials of a piece of work."""

    bf16: float = 0.0
    f32: float = 0.0
    bytes: float = 0.0
    exps: float = 0.0

    def __add__(self, o: "Work") -> "Work":
        return Work(self.bf16 + o.bf16, self.f32 + o.f32,
                    self.bytes + o.bytes, self.exps + o.exps)

    def least_s(self) -> float:
        return max(self.bytes / HBM_BYTES,
                   self.bf16 / BF16_FLOPS + self.f32 / F32_FLOPS,
                   self.exps / EXPS)


def least_s_serial(parts: Sequence[Work]) -> float:
    """Least time of passes that must run one after another."""
    return sum(p.least_s() for p in parts)


# ---------------------------------------------------------------- kernels --

def stream_pairs(T: int, L: int, n_init: int, n_local: int):
    """(visible (query, key) pairs a head, live window keys) of a video
    append of T tokens at positions L..L+T-1: init keys within the
    window, earlier and own video keys within it, and the init keys again
    for every query once L + T > n_local."""
    pairs = 0
    for t in range(T):
        P = L + t
        init = max(0, n_init - max(0, P - n_local + 1))
        win = P - max(n_init, P - n_local + 1) + 1
        pairs += init + win + (n_init if L + T > n_local else 0)
    live = (L + T) - max(n_init, L - n_local + 1)
    return pairs, live


def stream_attention(Hq: int, Hkv: int, D: int, T: int, L: int, n_init: int,
                     n_local: int, elem: int = 2) -> Work:
    """One stream_attention call at one stream: queries at two angles, the
    init keys (rotated and raw) and values, the live window pages' keys
    and values, and the output."""
    pairs, live = stream_pairs(T, L, n_init, n_local)
    by = elem * (3 * Hq * T * D + 3 * Hkv * n_init * D + 2 * Hkv * live * D)
    return Work(bf16=4 * Hq * D * pairs, bytes=by, exps=Hq * pairs)


def decode_attention(Hq: int, Hkv: int, D: int, start: int, T: int,
                     elem: int = 2) -> Work:
    """One decode_attention call of T needed queries at slots start..,
    each seeing every slot up to its own (the window covers the whole
    decode cache)."""
    pairs = T * start + T * (T + 1) // 2
    by = elem * (2 * Hq * T * D + 2 * Hkv * (start + T) * D)
    return Work(bf16=4 * Hq * D * pairs, bytes=by, exps=Hq * pairs)


def stream_attention_plain_flops(Hq: int, T: int, D: int, cover_keys: int,
                                 n_init: int) -> int:
    """The products the plain version computes (every cover key, masked
    or not): the count the port's FLOPs estimate adds for a launch."""
    return 4 * Hq * T * D * (cover_keys + 2 * n_init)


def cover_keys(n_local: int, S: int, exc: int) -> int:
    """Keys of the tile-aligned window cover a stream_attention call
    reads (the port's n_window_pages and pages_per_tile)."""
    w0 = -(-n_local // S) + exc // S
    W = -(-w0 // 8) * 8
    ppt = next((d for d in (8, 4, 2, 1) if d * S <= 512), 1)
    return (W // ppt + 1) * ppt * S


# ------------------------------------------------------------------ models --

def lm_layer_params(t: dict) -> int:
    E, F_, Hq, Hkv = (t["hidden_size"], t["intermediate_size"],
                      t["num_attention_heads"], t["num_key_value_heads"])
    D = E // Hq
    return E * (Hq + 2 * Hkv) * D + Hq * D * E + 3 * E * F_


def lm_pass(t: dict, tokens: int, attn: Work, head_rows: int = 0,
            elem: int = 2) -> Work:
    """One pass of `tokens` needed tokens through every LM layer (attn:
    the pass's attention, all layers), with the head for head_rows rows:
    the weights read once, the hidden states in and out."""
    E, V, nl = t["hidden_size"], t["vocab_size"], t["num_hidden_layers"]
    P = lm_layer_params(t)
    w = Work(bf16=2 * tokens * P * nl, bytes=elem * (P * nl + 2 * tokens * E))
    if head_rows:
        w = w + Work(bf16=2 * head_rows * E * V,
                     bytes=elem * E * V + 4 * head_rows * V)
    return w + attn


def vit_layer(C: int, F_: int, Tq: int, Tk: int, Tproj: int,
              Tmlp: int) -> float:
    """Products of one ViT layer: q/k/v/out projections of Tproj rows in
    all (counted by the caller), attention of Tq queries over Tk keys,
    the MLP of Tmlp rows."""
    return 2 * Tproj * C * C + 4 * Tq * Tk * C + 4 * Tmlp * C * F_


def siglip_frame(v: dict, cached: bool, ratio: float) -> float:
    """float32 products of one frame through the SigLIP tower: full, or
    the cacher's (fresh keys for every token; queries, values, attention,
    output projection and MLP for the U recomputed rows, attention over
    every key; the scattered values' correction U x U)."""
    C, F_, P = v["hidden_size"], v["intermediate_size"], v["patch_size"]
    T = (v["image_size"] // P) ** 2
    n = v["run_layers"]
    patch = 2 * T * 3 * P * P * C
    if not cached:
        return patch + n * vit_layer(C, F_, T, T, 4 * T, T)
    U = max(1, min(int(T * ratio), T))
    per = (2 * T * C * C + 2 * 3 * U * C * C + 4 * U * T * C
           + 2 * U * U * C + 4 * U * C * F_)
    return patch + n * per


def clip_frame(v: dict, cached: bool, skip: float) -> float:
    """float32 products of one frame through the CLIP tower's run layers:
    attention for every token; the MLP for every token, or on the cached
    path for the T - int(T * skip) recomputed ones."""
    C, F_, P = v["hidden_size"], v["intermediate_size"], v["patch_size"]
    T = (v["image_size"] // P) ** 2 + 1
    n = v["run_layers"]
    rows = T - max(0, min(T, int(T * skip))) if cached else T
    return 2 * (T - 1) * 3 * P * P * C + n * vit_layer(C, F_, T, T, 4 * T,
                                                       rows)


def vit_bytes(v: dict) -> float:
    C, F_, P = v["hidden_size"], v["intermediate_size"], v["patch_size"]
    per = 4 * C * C + 2 * C * F_
    return 4 * (v["run_layers"] * per + 3 * P * P * C)


def projector(c_in: int, c_out: int, rows: int) -> Work:
    return Work(f32=2 * rows * (c_in * c_out + c_out * c_out),
                bytes=4 * (c_in * c_out + c_out * c_out))


# ------------------------------------------------------------------- stats --

def tail(values: Sequence[float], q: float) -> float:
    """The q-quantile of every value, nearest rank: the ceil(q n)-th
    smallest."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    return xs[max(0, math.ceil(q * len(xs)) - 1)]


def rate(count: float, seconds: float) -> float:
    """Work over the whole window, not a median of pieces."""
    return count / seconds
