"""Fixed-capacity streaming KV-cache state (port of
``stc_tpu/kvcache/state.py``): the same leaves and shapes, as NamedTuples of
tensors.  A session holds one StreamKV whose leaves carry a leading layer
axis L; the engine works on one layer's slice (views into those tensors).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class StreamKV(NamedTuple):
    """Per-layer streaming KV state for one batch of streams."""

    init_k: torch.Tensor      # (B, Hkv, n_init, D) unrotated
    init_v: torch.Tensor      # (B, Hkv, n_init, D)
    block_k: torch.Tensor     # (B, Hkv, max_blocks, S, D) unrotated pages:
                              # state dtype, int8, or uint8 (..., D/2) int4
    block_v: torch.Tensor     # (B, Hkv, max_blocks, S, D)
    block_k_scale: torch.Tensor  # (B, Hkv, max_blocks, D) f32 page scales;
                                 # (B, Hkv, 0, D) without kv_quant
    block_v_scale: torch.Tensor
    block_rep: torch.Tensor   # (B, rep_cap, Hkv, D) mean key per block
    page_keep: torch.Tensor   # (B, max_blocks, S) bool
    num_blocks: torch.Tensor  # (B,) int32 total blocks appended
    page_offset: torch.Tensor  # (B,) int32 absolute index of slot 0
    length: torch.Tensor      # (B,) int32 total stream tokens appended


class DecodeKV(NamedTuple):
    """Per-layer QA cache: retrieved prefix + prompt + generated tokens,
    keys stored rotated at their slot position."""

    k: torch.Tensor       # (B, Hkv, decode_cap, D)
    v: torch.Tensor       # (B, Hkv, decode_cap, D)
    cursor: torch.Tensor  # (B,) int32 number of valid tokens


def layer(state, i: int):
    """Layer i's slice of a layer-stacked state (views, no copy)."""
    return type(state)(*(x[i] for x in state))
