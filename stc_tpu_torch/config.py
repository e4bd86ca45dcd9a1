"""Typed configuration of the PyTorch port.

A copy of the fields of ``stc_tpu/config.py`` that the LLaVA-OneVision +
ReKV session reads, with the same asserts.  The port keeps its own copy (it
imports nothing of the JAX package) and drops ``decode_attn_backend``:
attention on a CUDA tensor always runs the hand-written kernel, on a CPU
tensor always its plain version.  ``CacherConfig.gather_impl`` is kept so
the port takes every setting the JAX config does, but the port always
gathers rows by index (the one-hot gather exists only for TPU costs).
"""

from __future__ import annotations

import dataclasses


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ReKVConfig:
    """Streaming retrieval KV-cache hyperparameters (static capacities)."""

    n_init: int = 14              # init-prompt tokens kept resident forever
    n_local: int = 15000          # sliding local attention window
    block_size: int = 60          # tokens per KV block (== kept tokens/frame)
    exc_block_size: int = 60      # tokens per encode attention call
    topk: int = 64                # retrieved blocks per question
    chunk_size: int = 1           # retrieval scoring chunk grouping
    max_blocks: int = 1024        # capacity of the device page store (frames)
    max_rep_blocks: int = 0       # rep-key capacity (0 => 4 * max_blocks)
    max_new_tokens: int = 128     # decode budget per question
    max_prompt_tokens: int = 512  # static prompt-prefill capacity for QA
    kv_quant: str = "none"        # device pages: 'none' | 'int8' | 'int4'
    # host-tier pages of a float store: 'int8' (half the bytes of bf16 in
    # host memory and across the link, with f32 scales per page and dim)
    # | 'int4' (packed nibbles, a quarter) | 'none' (exact round trips);
    # a kv_quant store's pages go to the host as they are stored
    host_kv_quant: str = "int8"
    # prompt-lookup speculative decode: draft tokens a round (0: plain
    # greedy), the n-gram it matches, and the tokens of earlier questions
    # and answers kept per stream as draft material
    spec_decode_draft: int = 0
    spec_decode_ngram: int = 3
    spec_history_tokens: int = 0
    # ablation paths: block retrieval scorer 'mean_dot' (on the device) |
    # 'aks' | 'dpc_knn' | 'l2norm' (host-side selection between per-layer
    # forwards); retrieved-KV compression before QA attention ('none' or a
    # filter_tokens_* strategy: half of each retrieved block kept);
    # window compression at append time ('none' | 'select_top_half': each
    # appended page keeps its ceil(S/2) tokens of largest mean attention
    # output for later windows, through stream_attention's page_keep)
    retrieval_scorer: str = "mean_dot"
    retrieved_kv_compression: str = "none"
    window_kv_compression: str = "none"

    def __post_init__(self):
        assert self.exc_block_size <= self.n_local
        assert self.topk % self.chunk_size == 0
        assert self.retrieval_scorer in ("mean_dot", "aks", "dpc_knn",
                                         "l2norm"), self.retrieval_scorer
        assert self.host_kv_quant in ("none", "int8", "int4"), \
            self.host_kv_quant
        assert self.kv_quant in ("none", "int8", "int4"), self.kv_quant
        assert self.window_kv_compression in ("none", "select_top_half"), \
            self.window_kv_compression
        assert self.spec_decode_draft >= 0 and self.spec_decode_ngram >= 1
        assert self.spec_history_tokens >= 0

    @property
    def rep_cap(self) -> int:
        """Retrievable-history capacity in blocks."""
        return self.max_rep_blocks or 4 * self.max_blocks

    @property
    def local_cap(self) -> int:
        return _round_up(self.n_local + max(self.exc_block_size, self.n_init),
                         128)

    @property
    def retrieve_len(self) -> int:
        """Length of the retrieval buffer: init tokens + topk blocks."""
        return self.n_init + self.topk * self.block_size

    @property
    def retrieved_keep_per_block(self) -> int:
        """Tokens kept per retrieved block after retrieved-KV compression
        (the filter_tokens_* strategies keep half of each frame)."""
        if self.retrieved_kv_compression == "none":
            return self.block_size
        return self.block_size // 2

    @property
    def decode_cap(self) -> int:
        """Static capacity of the per-question decode KV cache."""
        return _round_up(
            self.retrieve_len + self.max_prompt_tokens + self.max_new_tokens
            + (self.spec_decode_draft + 1 if self.spec_decode_draft else 0),
            128)

    @property
    def rope_max_pos(self) -> int:
        """Largest relative position any attention call can see."""
        return max(self.n_local + self.exc_block_size, self.decode_cap) + 2


@dataclasses.dataclass(frozen=True)
class CacherConfig:
    """STC-Cacher (ViT selective recompute) knobs."""

    strategy: str = "cacher"          # 'none' | 'cacher'
    update_token_ratio: float = 0.25  # share of ViT tokens recomputed
    cache_interval: int = 2           # full recompute every Nth chunk
    sim_source: str = "key"           # 'key' | 'value' similarity gate
    gather_impl: str = "auto"         # the port always gathers by index
    # rank of the K-projection sketch that ranks staleness (0: the exact
    # fresh-K path; key similarity only)
    k_proxy_rank: int = 0

    @property
    def enabled(self) -> bool:
        return self.strategy == "cacher"


@dataclasses.dataclass(frozen=True)
class PrunerConfig:
    """STC-Pruner (post-projector token pruning) knobs."""

    strategy: str = "stc"        # 'stc' | 'none'
    token_per_frame: int = 60    # tokens kept per frame after pruning
    channel_keep_ratio: float = 0.5
    model_spec: str = "llava_ov"

    @property
    def enabled(self) -> bool:
        return self.strategy == "stc"


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """Per-backbone visual token layout."""

    tokens_per_frame: int
    index_mapper_type: str  # 'flat' | 'grid_13x13'


MODEL_SPECS = {
    "llava_ov": ModelSpec(tokens_per_frame=196, index_mapper_type="flat"),
    "llava_vid": ModelSpec(tokens_per_frame=169,
                           index_mapper_type="grid_13x13"),
    "clip": ModelSpec(tokens_per_frame=144, index_mapper_type="flat"),
}


@dataclasses.dataclass(frozen=True)
class SessionConfig:
    """Top-level streaming-session configuration."""

    rekv: ReKVConfig = dataclasses.field(default_factory=ReKVConfig)
    cacher: CacherConfig = dataclasses.field(default_factory=CacherConfig)
    pruner: PrunerConfig = dataclasses.field(default_factory=PrunerConfig)
    encode_chunk_frames: int = 1
    # LM weight storage: 'none' (the model dtype) | 'int8' (per-output-
    # channel weight-only quantization, Qwen2.quantize_int8) | 'int8_g<N>'
    # (one scale per group of N input rows; N divides every contraction dim)
    weights_quant: str = "none"
    # pixel ingest: 'rgb' ((B, n, H, W, 3) uint8 frames cross to the
    # device) | 'yuv420' (packed planar BT.601 4:2:0 planes, half the bytes
    # a frame; the chroma upsample and RGB matrix run on the device)
    ingest_format: str = "rgb"

    def __post_init__(self):
        assert (self.weights_quant in ("none", "int8")
                or (self.weights_quant.startswith("int8_g")
                    and self.weights_quant[6:].isdigit()
                    and int(self.weights_quant[6:]) > 0)), self.weights_quant
        assert self.ingest_format in ("rgb", "yuv420"), self.ingest_format

    @property
    def weights_quant_group(self) -> int:
        """Sub-channel group size (input rows per scale); 0 = per-channel."""
        if self.weights_quant.startswith("int8_g"):
            return int(self.weights_quant[6:])
        return 0
