"""Qwen2 decoder with streaming ReKV attention (port of
``stc_tpu/models/qwen2.py``, main-path subset).

An ``nn.Module`` holding the weights in the JAX package's (in, out) layout,
with q/k/v and gate/up fused into one matmul each (the same weights,
concatenated).  A Python loop over the layers replaces ``scan_layers``; the
stacked stream and decode states are updated in place, layer slice by layer
slice.  Entry points mirror the JAX call graph:

  encode_step       streaming prefill of one append (init prompt or video),
                    optionally for the active streams only
  qa_retrieve_step  question forward with per-layer top-k (or external)
                    retrieval, from the device store and, after evictions,
                    a prefetch table of host pages; the question's own KV
                    are not kept
  decode_step       prompt prefill / one-token decode over the decode cache
  greedy_decode     the answer loop, never emitting a stop token first;
                    with ReKVConfig.spec_decode_draft > 0 and a lookup
                    context, lookahead_decode instead
  lookahead_decode  prompt-lookup speculative decode: the same tokens as
                    greedy_decode, up to K + 1 of them per LM forward
  answer_question   retrieval + prefill + greedy decode
  answer_question_hosttier  one round of the two-tier QA: the retrieval
                    forward, then prefill and decode only if every
                    selected page was served (with `stage`, a layer whose
                    selection missed has its pages staged before it goes
                    on, so the round serves everything)
  qa_layer_logits / qa_layer_attend  the two halves of one layer of the
                    layerwise retrieval forward, for the host-side block
                    scorers (the session selects blocks between them)

With ReKVConfig.retrieved_kv_compression set, every retrieval forward
compresses each layer's retrieved prefix (engine.compress_retrieved)
before it enters the decode cache.

``Qwen2.quantize_int8`` turns the weights into int8 with float32 scales
(``stc_tpu``'s ``quantize_params_int8``); every matmul then dequantizes its
weight inside the call, at ``stc_tpu``'s rounding points (``_mm``).

On a mesh (``parallel.sharding.shard_module``) the module holds one rank's
part: under tp its Hq/tp and Hkv/tp heads, F/tp of the MLP hidden and
V/tp of the head's columns (``cfg`` is then the rank's config,
``full_cfg`` the model's), with one all_reduce after ``wo`` and one after
``w_down`` and the logits all_gathered before any token is picked, so
every tp rank picks the same one; under pp one stage's layers, every pass
a stage relay (parallel/pipeline.py); under sp an append's tokens split
over the sp ranks: each computes q/k/v of its own tokens, gathers the
chunk's new K/V rows, writes every page and attends its own queries.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F

from stc_tpu_torch.config import ReKVConfig
from stc_tpu_torch.device import resolve_device
from stc_tpu_torch.kvcache import engine
from stc_tpu_torch.kvcache.state import DecodeKV, StreamKV, layer
from stc_tpu_torch.ops.topk import argmax_lowest, top2_lowest
from stc_tpu_torch.parallel import pipeline


@dataclasses.dataclass(frozen=True)
class Qwen2Config:
    vocab_size: int = 151936
    hidden_size: int = 3584
    num_layers: int = 28
    num_heads: int = 28
    num_kv_heads: int = 4
    head_dim: int = 128
    intermediate_size: int = 18944
    rope_base: float = 1000000.0
    rms_eps: float = 1e-6
    tie_embeddings: bool = False
    qkv_bias: bool = True

    @classmethod
    def tiny(cls, vocab=256):
        """Small config for tests."""
        return cls(vocab_size=vocab, hidden_size=64, num_layers=2,
                   num_heads=4, num_kv_heads=2, head_dim=16,
                   intermediate_size=128, rope_base=10000.0,
                   tie_embeddings=False)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


# the matrices quantize_int8 stores as int8 in each layer
QUANT_MATRICES = ("wqkv", "wo", "w_gateup", "w_down")


def quantize_weight(w: torch.Tensor, group_size: int = 0):
    """Symmetric int8 of an (in, out) matrix: (int8 (in, out), float32
    scales), the scales (out,) per output channel, or (in/G, out) per group
    of G = group_size input rows.  stc_tpu's quantize_params_int8: scale =
    max(max |w|, 1e-8) / 127 over the rows it covers, q = round(w / scale),
    half to even."""
    wf = w.to(torch.float32)
    if group_size:
        n_in, n_out = wf.shape
        if n_in % group_size:
            raise ValueError(f"group size {group_size} does not divide the "
                             f"{n_in} input rows of a {tuple(w.shape)} "
                             "matrix")
        wf = wf.reshape(n_in // group_size, group_size, n_out)
    s = _int8_scale(wf.abs().amax(dim=-2, keepdim=True))
    q = torch.round(wf / s).to(torch.int8).reshape(w.shape)
    return q, s.squeeze(-2)


def _int8_scale(amax: torch.Tensor) -> torch.Tensor:
    """max(amax, 1e-8) / 127, correctly rounded on every device: CUDA
    divides by a Python number through its reciprocal, which can land an
    ulp away, so the divisor is a tensor."""
    a = amax.clamp_min(1e-8)
    return a / torch.full_like(a, 127.0)


class Qwen2Layer(nn.Module):
    def __init__(self, cfg: Qwen2Config, dtype, device):
        super().__init__()
        E, F_ = cfg.hidden_size, cfg.intermediate_size
        qkv = (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim

        def p(*shape):
            return nn.Parameter(torch.zeros(shape, dtype=dtype,
                                            device=device),
                                requires_grad=False)

        self.ln1, self.ln2 = p(E), p(E)
        self.wqkv, self.bqkv = p(E, qkv), p(qkv)
        self.wo = p(cfg.num_heads * cfg.head_dim, E)
        self.w_gateup, self.w_down = p(E, 2 * F_), p(F_, E)


class Qwen2(nn.Module):
    """The streaming LM.  Weights start zeroed: fill them with
    init_random_params or weights.qwen2_from_jax."""

    def __init__(self, cfg: Qwen2Config, dtype=torch.bfloat16,
                 device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.cfg = self.full_cfg = cfg
        # a mesh's axes (set_mesh); None: unsharded
        self.mesh = self.tp = self.sp = self.pp = None
        self.layer_offset = 0  # global index of the first layer held
        E, V = cfg.hidden_size, cfg.vocab_size
        self.embed = nn.Parameter(torch.zeros(V, E, dtype=dtype,
                                              device=device),
                                  requires_grad=False)
        self.layers = nn.ModuleList(Qwen2Layer(cfg, dtype, device)
                                    for _ in range(cfg.num_layers))
        self.norm_f = nn.Parameter(torch.zeros(E, dtype=dtype, device=device),
                                   requires_grad=False)
        self.lm_head = nn.Parameter(torch.zeros(E, V, dtype=dtype,
                                                device=device),
                                    requires_grad=False)

        # None: weights in the model dtype; else quantize_int8's group size
        # (0: int8 per output channel)
        self.int8_group: Optional[int] = None
        # lookahead_decode's verify rounds, the live streams summed over
        # those rounds and the tokens they committed, since this module was
        # built (observability: tokens per verify round)
        self.spec_rounds = 0
        self.spec_stream_rounds = 0
        self.spec_tokens = 0

    def set_mesh(self, mesh) -> None:
        """Take the axes of `mesh` (the tensors already hold this rank's
        slices, parallel/sharding.shard_module): cfg becomes the rank's
        heads, MLP hidden and layer count."""
        self.mesh = mesh
        tp, sp, pp = (mesh.axis(n) for n in ("tp", "sp", "pp"))
        self.tp = tp if tp.size > 1 else None
        self.sp = sp if sp.size > 1 else None
        self.pp = pp if pp.size > 1 else None
        c = self.full_cfg
        self.cfg = dataclasses.replace(
            c, num_heads=c.num_heads // tp.size,
            num_kv_heads=c.num_kv_heads // tp.size,
            intermediate_size=c.intermediate_size // tp.size,
            num_layers=len(self.layers))

    def _tp_sum(self, x, site):
        return x if self.tp is None else self.tp.all_reduce(x, site=site)

    @property
    def dtype(self):
        return self.norm_f.dtype

    @property
    def device(self):
        return self.norm_f.device

    @torch.no_grad()
    def init_random_params(self, generator: torch.Generator,
                           scale: float = 0.02) -> "Qwen2":
        """N(0, 1) * scale matrices, zero biases, unit norms (the JAX
        package's random init; the draws differ, the distribution not)."""
        def rnd(p):
            x = torch.randn(p.shape, generator=generator,
                            device=generator.device, dtype=torch.float32)
            p.copy_(x * scale)

        rnd(self.embed)
        rnd(self.lm_head)
        self.norm_f.fill_(1.0)
        for lp in self.layers:
            lp.ln1.fill_(1.0)
            lp.ln2.fill_(1.0)
            lp.bqkv.zero_()
            for w in (lp.wqkv, lp.wo, lp.w_gateup, lp.w_down):
                rnd(w)
        return self

    @torch.no_grad()
    def quantize_int8(self, group_size: int = 0) -> "Qwen2":
        """Weight-only int8, in place (stc_tpu's quantize_params_int8): each
        layer's wqkv / wo / w_gateup / w_down and lm_head become `<name>_q`
        int8 buffers with float32 scales `<name>_s` (out,) per output
        channel, or `<name>_gs` (in/G, out) per group of G = group_size
        input rows; embed becomes int8 rows `embed_q` with per-row scales
        `embed_s`.  Norms and biases stay in the model dtype.  One matrix
        at a time, each freed once quantized, so the peak above the model
        is one matrix's temporaries.  Idempotent: a quantized model is
        returned as it is."""
        if self.int8_group is not None:
            return self
        if self.tp is not None:
            raise ValueError("quantize the whole Qwen2 before sharding it "
                             "over tp: a row-parallel weight's per-channel "
                             "scale is a maximum over all its rows")
        skey = "_gs" if group_size else "_s"

        def swap(mod, name, q, suffix, s):
            delattr(mod, name)
            mod.register_buffer(name + "_q", q)
            mod.register_buffer(name + suffix, s)

        for lp in self.layers:
            for name in QUANT_MATRICES:
                q, s = quantize_weight(getattr(lp, name), group_size)
                swap(lp, name, q, skey, s)
        e = self.embed.to(torch.float32)
        s = _int8_scale(e.abs().amax(dim=-1, keepdim=True))
        q = torch.round(e / s).to(torch.int8)
        del e
        swap(self, "embed", q, "_s", s[:, 0])
        q, s = quantize_weight(self.lm_head, group_size)
        swap(self, "lm_head", q, skey, s)
        self.int8_group = group_size
        return self

    # ------------------------------------------------------------------ #
    def init_stream_state(self, rekv: ReKVConfig, batch: int,
                          dtype=torch.bfloat16) -> StreamKV:
        c = self.cfg
        return engine.init_stream_kv(rekv, batch, c.num_kv_heads, c.head_dim,
                                     dtype, device=self.device,
                                     layers=c.num_layers)

    def init_decode_state(self, rekv: ReKVConfig, batch: int,
                          dtype=torch.bfloat16) -> DecodeKV:
        c = self.cfg
        return engine.init_decode_kv(rekv, batch, c.num_kv_heads, c.head_dim,
                                     dtype, device=self.device,
                                     layers=c.num_layers)

    def embed_tokens(self, ids: torch.Tensor) -> torch.Tensor:
        ids = ids.to(torch.int64)
        if self.int8_group is None:
            return self.embed[ids]
        dt = self.dtype
        return self.embed_q[ids].to(dt) * self.embed_s[ids][..., None].to(dt)

    def _mm(self, h: torch.Tensor, mod: nn.Module, name: str):
        """h @ mod.<name>; on int8 weights the weight dequantizes inside
        the call at stc_tpu's rounding points (qwen2._mm): per channel
        (h @ q.to(h.dtype)) * s.to(h.dtype); per group the weight in
        float32 times its group's scales, rounded once to h.dtype, then
        one matmul."""
        if self.int8_group is None:
            return h @ getattr(mod, name)
        q = getattr(mod, name + "_q")
        if not self.int8_group:
            return (h @ q.to(h.dtype)) * getattr(mod, name + "_s").to(h.dtype)
        gs = getattr(mod, name + "_gs")
        n_in, n_out = q.shape
        w = (q.reshape(gs.shape[0], -1, n_out).to(torch.float32)
             * gs[:, None, :]).to(h.dtype)
        return h @ w.reshape(n_in, n_out)

    def _qkv(self, lp: Qwen2Layer, h: torch.Tensor):
        c = self.cfg
        B, T, _ = h.shape
        Hq, Hkv, D = c.num_heads, c.num_kv_heads, c.head_dim
        qkv = self._mm(h, lp, "wqkv") + lp.bqkv
        q, k, v = qkv.split([Hq * D, Hkv * D, Hkv * D], dim=-1)
        q = q.reshape(B, T, Hq, D).transpose(1, 2)
        k = k.reshape(B, T, Hkv, D).transpose(1, 2)
        v = v.reshape(B, T, Hkv, D).transpose(1, 2)
        return q, k, v

    def _proj_out(self, lp: Qwen2Layer, o):
        B, Hq, T, D = o.shape
        return self._tp_sum(self._mm(o.transpose(1, 2).reshape(
            B, T, Hq * D), lp, "wo"), "qwen2.attn_out")

    def _mlp(self, lp: Qwen2Layer, h):
        g, u = self._mm(h, lp, "w_gateup").chunk(2, dim=-1)
        return self._tp_sum(self._mm(F.silu(g) * u, lp, "w_down"),
                            "qwen2.mlp_out")

    def _finish_layer(self, lp: Qwen2Layer, h, o):
        """Attention output projection and residual, then the MLP."""
        h = h + self._proj_out(lp, o)
        return h + self._mlp(lp, rms_norm(h, lp.ln2, self.cfg.rms_eps))

    def _lm_head(self, h):
        logits = self._mm(rms_norm(h, self.norm_f, self.cfg.rms_eps), self,
                          "lm_head")
        if self.tp is None:
            return logits
        return self.tp.all_gather(logits, dim=-1, site="qwen2.lm_head")

    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def encode_step(self, rekv: ReKVConfig, kvs: StreamKV,
                    embeds: torch.Tensor, *, is_init: bool,
                    active: Optional[torch.Tensor] = None):
        """One streaming append of embeds (B, T, E) through every layer;
        kvs is updated in place.  active: optional (B,) bool ragged mask,
        inactive streams' state untouched (engine.append_stream).  Returns
        (final hidden states, kvs).  Under sp, when each sp rank's share of
        a video append is whole pages, the hidden states are this rank's
        tokens; under pp, the last stage's are the append's."""
        c = self.cfg
        T = embeds.shape[1]
        rc = None
        if not is_init:  # position tables are shared by every layer
            rc = engine.make_rope_cache(
                kvs.length[0], kvs.num_blocks[0], T, rekv,
                c.head_dim, c.rope_base, kvs.page_offset[0])
        sp = self.sp
        if sp is not None and (is_init or T % (sp.size * rekv.block_size)):
            sp = None  # not whole pages a rank: every sp rank runs it all
        off = 0 if sp is None else sp.rank * (T // sp.size)
        x = embeds if sp is None else embeds[:, off:off + T // sp.size]

        def layers(h):
            for i, lp in enumerate(self.layers):
                q, k, v = self._qkv(lp, rms_norm(h, lp.ln1, c.rms_eps))
                if sp is not None:  # the chunk's new K/V rows
                    k, v = sp.all_gather(torch.stack([k, v]), dim=3,
                                         site="sp.kv").unbind(0)
                o, _ = engine.append_stream(
                    layer(kvs, i), q, k, v, rekv, is_init=is_init,
                    rope_base=c.rope_base, rope_cache=rc, active=active,
                    tp=self.tp, sp=sp, q_offset=off)
                h = self._finish_layer(lp, h, o)
            return h

        return pipeline.pipe(self.pp, layers, x, replicate=False), kvs

    @torch.no_grad()
    def qa_retrieve_step(self, rekv: ReKVConfig, kvs: StreamKV,
                         dkvs: DecodeKV, embeds: torch.Tensor,
                         n_tokens: Optional[torch.Tensor] = None,
                         retrieved_indices: Optional[torch.Tensor] = None):
        """Question forward with per-layer retrieval; installs each layer's
        retrieved prefix into the decode cache (in place).
        retrieved_indices: optional (B, topk) external block indices (-1
        padded) used at every layer instead of the top-k.  Returns (dkvs,
        abs_idx (L, B, topk), exists (L, B, topk)): the blocks each layer
        selected, for observability."""
        dkvs, abs_idx, exists, _ = self._qa_forward(
            rekv, kvs, dkvs, embeds, n_tokens, retrieved_indices, None)
        return dkvs, abs_idx, exists

    @torch.no_grad()
    def qa_retrieve_hosttier_step(self, rekv: ReKVConfig, kvs: StreamKV,
                                  dkvs: DecodeKV, embeds: torch.Tensor,
                                  n_tokens, hp_kv: torch.Tensor,
                                  hp_ids: torch.Tensor,
                                  retrieved_indices=None, stage=None):
        """qa_retrieve_step over both KV tiers: evicted pages come from the
        prefetch table hp_kv (2, L, B, Hkv, M, S, D), hp_ids (L, B, M).
        stage: optional callable (layer, abs_idx, missing) -> (hp_kv,
        hp_ids), called (after one host read of that layer's `missing`)
        when a layer's selection missed: it stages the pages and returns
        the table to gather from again.  Returns (dkvs, abs_idx, exists,
        missing (L, B, topk)): selected pages in neither tier
        (engine.retrieve_blocks_hosttier)."""
        return self._qa_forward(rekv, kvs, dkvs, embeds, n_tokens,
                                retrieved_indices, (hp_kv, hp_ids), stage)

    def _qa_forward(self, rekv, kvs, dkvs, embeds, n_tokens,
                    retrieved_indices, host_pages, stage=None):
        c = self.cfg
        B, T, _ = embeds.shape
        dev = embeds.device
        seed = compress_seed(rekv, kvs)
        q_valid = None
        if n_tokens is not None:
            n_tokens = torch.as_tensor(n_tokens, device=dev).expand(B)
            q_valid = torch.arange(T, device=dev)[None, :] < n_tokens[:, None]
        picked = []

        def layers(h):
            for i, lp in enumerate(self.layers):
                h = layer_pass(i, lp, h)
            return h

        def layer_pass(i, lp, h):
            nonlocal host_pages
            q, k, v = self._qkv(lp, rms_norm(h, lp.ln1, c.rms_eps))
            kv = layer(kvs, i)
            if retrieved_indices is None:
                abs_idx, exists = engine.score_blocks(kv, q, rekv, q_valid,
                                                      tp=self.tp)
            else:
                abs_idx, exists = engine.external_blocks(kv,
                                                         retrieved_indices)
            if host_pages is None:
                ret_k, ret_v, _, valid_len = engine.retrieve_scored(
                    kv, rekv, abs_idx, exists)
                missing = None
            else:
                def gather(hp_kv, hp_ids):
                    return engine.retrieve_blocks_hosttier(
                        kv, rekv, abs_idx, exists, hp_kv[0, i], hp_kv[1, i],
                        hp_ids[i])
                ret_k, ret_v, _, valid_len, missing = gather(*host_pages)
                if stage is not None and bool(missing.any()):
                    host_pages = stage(i, abs_idx, missing)
                    ret_k, ret_v, _, valid_len, missing = gather(*host_pages)
            picked.append((abs_idx, exists, missing))
            h, dkvs.cursor[i] = self._attend_retrieved(
                i, rekv, kv, layer(dkvs, i), h, q, k, v, ret_k, ret_v,
                valid_len, compress_generator(seed, dev))
            return h

        # the pass's hidden states end here: the decode cache holds it all
        pipeline.pipe(self.pp, layers, embeds, replicate=False)
        abs_idx, exists = (torch.stack([p[j] for p in picked])
                           for j in (0, 1))
        missing = (None if host_pages is None
                   else torch.stack([p[2] for p in picked]))
        return dkvs, abs_idx, exists, missing

    @torch.no_grad()
    def qa_layer_logits(self, i: int, rekv: ReKVConfig, kv: StreamKV,
                        h: torch.Tensor, n_tokens: torch.Tensor):
        """Layerwise QA, first half of layer i: the layer's q, k, v and the
        raw rep-relevance logits (B, Rc), their validity and the mean
        question query (B, Hq, D), for a host-side selection strategy.
        kv: the layer's stream state."""
        c = self.cfg
        T = h.shape[1]
        q_valid = torch.arange(T, device=h.device)[None, :] < \
            n_tokens[:, None]
        q, k, v = self._qkv(self.layers[i], rms_norm(h, self.layers[i].ln1,
                                                     c.rms_eps))
        logits, blk_valid, q_mean = engine.score_block_logits(
            kv, q, rekv, q_valid, tp=self.tp)
        return q, k, v, logits, blk_valid, q_mean

    @torch.no_grad()
    def qa_layer_attend(self, i: int, rekv: ReKVConfig, kv: StreamKV,
                        dkv: DecodeKV, h: torch.Tensor, q, k, v,
                        abs_idx: torch.Tensor, exists: torch.Tensor,
                        use_host: torch.Tensor, host_k: torch.Tensor,
                        host_v: torch.Tensor,
                        generator: Optional[torch.Generator] = None):
        """Layerwise QA, second half of layer i: the retrieved attention
        over the selected blocks abs_idx (B, topk) (`exists` marks real
        selections), resident pages gathered from the store and those
        where use_host (B, topk) from host_k / host_v (B, topk, Hkv, S, D),
        compressed as configured; the prefix is installed into the layer's
        decode cache dkv (in place) and the question attends it.  Returns
        (h of the next layer, valid_len (B,) int32: the layer's cursor)."""
        B = h.shape[0]
        S, nI = rekv.block_size, rekv.n_init
        slot = (abs_idx - kv.page_offset[:, None]).clamp(0,
                                                         rekv.max_blocks - 1)
        ret_k, ret_v, _, valid_len = engine._gather_retrieved(kv, rekv, slot,
                                                              exists)
        Hkv, D = host_k.shape[2], host_k.shape[-1]
        m = use_host.repeat_interleave(S, dim=1)[:, None, :, None]
        for ret, hp in ((ret_k, host_k), (ret_v, host_v)):
            hp = hp.transpose(1, 2).reshape(B, Hkv, rekv.topk * S, D)
            ret[:, :, nI:] = torch.where(m, hp.to(ret.dtype),
                                         ret[:, :, nI:])
        return self._attend_retrieved(i, rekv, kv, dkv, h, q, k, v, ret_k,
                                      ret_v, valid_len, generator)

    def _attend_retrieved(self, i, rekv, kv, dkv, h, q, k, v, ret_k, ret_v,
                          valid_len, generator=None):
        """Layer i's retrieved prefix, compressed as configured, into its
        decode cache dkv (in place); the question attends it with its own
        KV, which join this forward only (the cursor stays at the prefix).
        Returns (h of the next layer, the prefix length (B,) int32)."""
        c = self.cfg
        T = h.shape[1]
        if rekv.retrieved_kv_compression != "none":
            ret_k, ret_v, valid_len = engine.compress_retrieved(
                kv, rekv, ret_k, ret_v, valid_len, generator, tp=self.tp)
        raw_rows = rekv.n_init if rekv.decode_cap > rekv.n_local else 0
        dkv = engine.decode_write(dkv, ret_k, ret_v, valid_len,
                                  at_start=True, rope_base=c.rope_base,
                                  raw_rows=raw_rows)
        dkv_q = engine.decode_write(dkv, k, v, T, rope_base=c.rope_base)
        ar = torch.arange(T, device=h.device)[None, :]
        o = engine.decode_attend(q, valid_len[:, None] + ar, dkv_q, rekv,
                                 rope_base=c.rope_base)
        return self._finish_layer(self.layers[i], h, o), valid_len

    @torch.no_grad()
    def decode_step(self, rekv: ReKVConfig, dkvs: DecodeKV,
                    embeds: torch.Tensor, n_tokens):
        """Prompt prefill (T tokens, n_tokens (B,) valid) or 1-token decode.
        Returns (logits (B, T, V), dkvs updated in place)."""
        c = self.cfg
        B, T, _ = embeds.shape
        ar = torch.arange(T, device=embeds.device)[None, :]

        def layers(h):
            for i, lp in enumerate(self.layers):
                q, k, v = self._qkv(lp, rms_norm(h, lp.ln1, c.rms_eps))
                dl = layer(dkvs, i)
                start = dl.cursor.clone()
                dl = engine.decode_write(dl, k, v, n_tokens,
                                         rope_base=c.rope_base)
                o = engine.decode_attend(q, start[:, None] + ar, dl, rekv,
                                         rope_base=c.rope_base)
                dkvs.cursor[i] = dl.cursor
                h = self._finish_layer(lp, h, o)
            return h

        h = pipeline.pipe(self.pp, layers, embeds, replicate=True)
        return self._lm_head(h), dkvs

    @torch.no_grad()
    def greedy_decode(self, rekv: ReKVConfig, dkvs: DecodeKV,
                      last_logits: torch.Tensor, stop_ids: torch.Tensor,
                      max_new_tokens: int,
                      ctx_ids: Optional[torch.Tensor] = None,
                      ctx_len: Optional[torch.Tensor] = None):
        """Greedy decode from the prompt's last logits (B, V); step 0 never
        emits a stop token (top-2 fallback).  stop_ids: (n,) int32, -1
        padded.  Returns (tokens (B, max_new_tokens) int32, n_generated
        (B,) int32, dkvs); every loop step runs one decode_step, and the
        loop stops once every stream has emitted a stop token.  With
        rekv.spec_decode_draft > 0 and a lookup context ctx_ids / ctx_len
        (build_spec_ctx), lookahead_decode runs instead: the same tokens
        in fewer forwards."""
        if rekv.spec_decode_draft > 0 and ctx_ids is not None:
            return self.lookahead_decode(rekv, dkvs, last_logits, stop_ids,
                                         max_new_tokens, ctx_ids, ctx_len)
        B = last_logits.shape[0]
        dev = last_logits.device
        stop_ids = stop_ids.to(dev)
        tokens = torch.zeros((B, max_new_tokens), dtype=torch.int32,
                             device=dev)
        count = torch.zeros((B,), dtype=torch.int32, device=dev)
        done = torch.zeros((B,), dtype=torch.bool, device=dev)
        ones = torch.ones((B,), dtype=torch.int32, device=dev)
        logits = last_logits
        for i in range(max_new_tokens):
            top2 = top2_lowest(logits).to(torch.int32)
            tok = top2[:, 0]
            if i == 0:
                first_stop = (tok[:, None] == stop_ids[None, :]).any(dim=1)
                tok = torch.where(first_stop, top2[:, 1], tok)
            record = ~done
            tokens[:, i] = torch.where(record, tok, 0)
            count += record.to(torch.int32)
            done = done | (tok[:, None] == stop_ids[None, :]).any(dim=1)
            logits, dkvs = self.decode_step(rekv, dkvs,
                                            self.embed_tokens(tok[:, None]),
                                            ones)
            logits = logits[:, 0]
            if bool(done.all()):
                break
        return tokens, count, dkvs

    @torch.no_grad()
    def lookahead_decode(self, rekv: ReKVConfig, dkvs: DecodeKV,
                         last_logits: torch.Tensor, stop_ids: torch.Tensor,
                         max_new_tokens: int, ctx_ids: torch.Tensor,
                         ctx_len: torch.Tensor):
        """Greedy decode by prompt lookup (stc_tpu's lookahead_decode).
        Each round commits the next greedy token tok0, drafts K =
        rekv.spec_decode_draft tokens by the longest-suffix n-gram match
        over the lookup context (_spec_draft), runs ONE decode_step over
        the K + 1 tokens, and commits the longest draft prefix equal to
        the model's own greedy choices, cut at a stop token and at the
        budget.  Every layer's cursor then rewinds to start + committed:
        the rejected rows stay in the cache past the cursor, where the
        next round writes its own K + 1 rows before it attends; a row
        still past those lies ahead of every query (causal mask) and past
        the cursor (`slot < cursor`).  The tokens equal greedy_decode's,
        the anti-stop rule at step 0 included.  One host read a round
        (are any streams live, and the round's counters).  Returns (tokens
        (B, max_new_tokens) int32, n_generated (B,) int32, dkvs)."""
        B = last_logits.shape[0]
        K, N = rekv.spec_decode_draft, rekv.spec_decode_ngram
        dev = last_logits.device
        C = ctx_ids.shape[1]
        i32 = torch.int32
        stop_ids = stop_ids.to(dev)
        bidx = torch.arange(B, device=dev)

        def is_stop(tok):
            return (tok[:, None] == stop_ids[None, :]).any(dim=1)

        def put(buf, at, val, where):
            """buf[b, at[b]] = val[b] where `where`, per stream."""
            buf[bidx, at] = torch.where(where, val, buf[bidx, at])

        tokens = torch.zeros((B, max_new_tokens), dtype=i32, device=dev)
        pos = torch.zeros((B,), dtype=i32, device=dev)
        done = torch.zeros((B,), dtype=torch.bool, device=dev)
        ctx = ctx_ids.to(device=dev, dtype=i32).clone()
        cl = ctx_len.to(device=dev, dtype=i32).clone()
        n_tok = torch.full((B,), K + 1, dtype=i32, device=dev)
        logits, n_live = last_logits, B
        for _ in range(max_new_tokens):
            self.spec_rounds += 1
            self.spec_stream_rounds += n_live
            top2 = top2_lowest(logits).to(i32)
            tok0 = torch.where((pos == 0) & is_stop(top2[:, 0]), top2[:, 1],
                               top2[:, 0])
            # tok0 joins the lookup context, so the draft follows it
            put(ctx, cl.clamp(0, C - 1), tok0, ~done)
            cl = cl + (~done).to(i32)
            draft = _spec_draft(ctx, cl, K, N)
            seq = torch.cat([tok0[:, None], draft], dim=1)        # (B, K+1)
            start = dkvs.cursor.clone()
            logits_all, dkvs = self.decode_step(
                rekv, dkvs, self.embed_tokens(seq), n_tok)
            y = argmax_lowest(logits_all).to(i32)                 # (B, K+1)
            n_draft = torch.cumprod((draft == y[:, :K]).to(i32),
                                    dim=1).sum(dim=1)
            # the committed run seq[0 .. n_draft], cut at the first stop
            # token and at the budget; accepted drafts join the context
            committed = torch.zeros((B,), dtype=i32, device=dev)
            d = done
            for t in range(K + 1):
                tk = seq[:, t]
                can = (~d) & (t <= n_draft) & (pos + committed
                                               < max_new_tokens)
                put(tokens, (pos + committed).clamp(0, max_new_tokens - 1),
                    tk, can)
                if t > 0:
                    put(ctx, cl.clamp(0, C - 1), tk, can)
                    cl = cl + can.to(i32)
                committed = committed + can.to(i32)
                d = d | (can & is_stop(tk))
            # the next round follows the last committed token
            logits = logits_all[bidx, (committed - 1).clamp(0, K)]
            dkvs.cursor.copy_(start + committed[None, :])
            pos, done = pos + committed, d
            # the round's one host read
            n_live, n_new = torch.stack([(~done & (pos < max_new_tokens))
                                         .sum(), committed.sum()]).tolist()
            self.spec_tokens += n_new
            if not n_live:
                break
        return tokens, pos, dkvs

    @torch.no_grad()
    def answer_question(self, rekv: ReKVConfig, kvs: StreamKV,
                        q_ids: torch.Tensor, q_len: torch.Tensor,
                        p_ids: torch.Tensor, p_len: torch.Tensor,
                        stop_ids: torch.Tensor, max_new_tokens: int,
                        retrieved_indices: Optional[torch.Tensor] = None,
                        hist_ids: Optional[torch.Tensor] = None,
                        hist_len: Optional[torch.Tensor] = None):
        """Retrieval forward + prompt prefill + greedy decode.  hist_ids
        (B, H) / hist_len (B,): earlier questions and answers per stream,
        draft material of the speculative decode (never output).  Returns
        (tokens, n_generated, abs_idx (L, B, topk), exists)."""
        B = q_ids.shape[0]
        dkvs = self.init_decode_state(rekv, B, kvs.init_k.dtype)
        dkvs, abs_idx, exists = self.qa_retrieve_step(
            rekv, kvs, dkvs, self.embed_tokens(q_ids), n_tokens=q_len,
            retrieved_indices=retrieved_indices)
        tokens, count = self._answer(rekv, dkvs, q_ids, q_len, p_ids, p_len,
                                     stop_ids, max_new_tokens, hist_ids,
                                     hist_len)
        return tokens, count, abs_idx, exists

    @torch.no_grad()
    def answer_question_hosttier(self, rekv: ReKVConfig, kvs: StreamKV,
                                 q_ids, q_len, p_ids, p_len, stop_ids,
                                 max_new_tokens: int, hp_kv, hp_ids,
                                 retrieved_indices=None, stage=None,
                                 hist_ids=None, hist_len=None):
        """One round of the two-tier QA: the retrieval forward over the
        store and the prefetch table (with `stage`, layer by layer, see
        qa_retrieve_hosttier_step), then -- only when no layer missed a
        selected page (one host read of `missing`) -- prompt prefill and
        greedy decode (hist_ids / hist_len as in answer_question); a miss
        round returns zero tokens.  Returns (tokens, n_generated, abs_idx,
        exists, missing)."""
        B = q_ids.shape[0]
        dkvs = self.init_decode_state(rekv, B, kvs.init_k.dtype)
        dkvs, abs_idx, exists, missing = self.qa_retrieve_hosttier_step(
            rekv, kvs, dkvs, self.embed_tokens(q_ids), q_len, hp_kv, hp_ids,
            retrieved_indices=retrieved_indices, stage=stage)
        if bool(missing.any()):
            z = torch.zeros((B, max_new_tokens), dtype=torch.int32,
                            device=q_ids.device)
            return z, z[:, 0], abs_idx, exists, missing
        tokens, count = self._answer(rekv, dkvs, q_ids, q_len, p_ids, p_len,
                                     stop_ids, max_new_tokens, hist_ids,
                                     hist_len)
        return tokens, count, abs_idx, exists, missing

    def _answer(self, rekv, dkvs, q_ids, q_len, p_ids, p_len, stop_ids,
                max_new_tokens, hist_ids=None, hist_len=None):
        """Prompt prefill over the installed decode cache, then greedy
        decode (speculative over [history | question | prompt] when
        rekv.spec_decode_draft > 0): (tokens, n_generated)."""
        B = p_ids.shape[0]
        logits, dkvs = self.decode_step(rekv, dkvs, self.embed_tokens(p_ids),
                                        p_len)
        bidx = torch.arange(B, device=logits.device)
        last = logits[bidx, p_len.to(torch.int64) - 1]
        ctx = {}
        if rekv.spec_decode_draft > 0:
            c_ids, c_len = build_spec_ctx(q_ids, q_len, p_ids, p_len,
                                          max_new_tokens, hist_ids, hist_len)
            ctx = dict(ctx_ids=c_ids, ctx_len=c_len)
        tokens, count, _ = self.greedy_decode(rekv, dkvs, last, stop_ids,
                                              max_new_tokens, **ctx)
        return tokens, count


def compress_seed(rekv: ReKVConfig, kvs: StreamKV) -> Optional[int]:
    """The seed of filter_tokens_random's draws in one retrieval forward:
    stream 0's length (one host read; None for the other strategies).  The
    JAX engine folds the same length into a fixed key and draws the same
    permutation at every layer; the port reseeds a generator per layer."""
    if rekv.retrieved_kv_compression != "filter_tokens_random":
        return None
    return int(kvs.length.reshape(-1)[0])


def compress_generator(seed: Optional[int], device):
    """A generator on `device` seeded with `seed`, or None."""
    if seed is None:
        return None
    return torch.Generator(device=device).manual_seed(seed)


def build_spec_ctx(q_ids: torch.Tensor, q_len: torch.Tensor,
                   p_ids: torch.Tensor, p_len: torch.Tensor,
                   max_new_tokens: int,
                   hist_ids: Optional[torch.Tensor] = None,
                   hist_len: Optional[torch.Tensor] = None):
    """The per-stream lookup context of the speculative decode: [history |
    question | prompt], compacted (padding dropped), with room for the
    generated tokens.  hist_ids (B, H): recent question and answer tokens
    of the stream's earlier questions.  Returns (ctx (B, C) int32, ctx_len
    (B,) int32), C = H + Tq + Tp + max_new_tokens + 2."""
    B, Tq = q_ids.shape
    Tp = p_ids.shape[1]
    H = 0 if hist_ids is None else hist_ids.shape[1]
    dev, i32 = q_ids.device, torch.int32
    C = H + Tq + Tp + max_new_tokens + 2
    ctx = torch.zeros((B, C), dtype=i32, device=dev)
    bidx = torch.arange(B, device=dev)[:, None]
    base = torch.zeros((B,), dtype=i32, device=dev)
    q_len = torch.as_tensor(q_len, device=dev).to(i32)
    p_len = torch.as_tensor(p_len, device=dev).to(i32)
    if H:
        hist_len = torch.as_tensor(hist_len, device=dev).to(i32)
        jh = torch.arange(H, device=dev)[None, :]
        ctx[:, :H] = torch.where(jh < hist_len[:, None], hist_ids.to(i32), 0)
        base = hist_len
    for ids, n, off in ((q_ids, q_len, base), (p_ids, p_len, base + q_len)):
        j = torch.arange(ids.shape[1], device=dev)[None, :]
        ctx[bidx, off[:, None] + j] = torch.where(j < n[:, None],
                                                  ids.to(i32), 0)
    return ctx, base + q_len + p_len


def _spec_draft(ctx: torch.Tensor, ctx_len: torch.Tensor, K: int, N: int):
    """K draft tokens per stream: the continuation of the most recent
    position whose trailing n-gram (up to N tokens) equals the committed
    suffix of ctx[:, :ctx_len] (the longest match first, then the latest,
    as argmax(score * C + t)); zeros where nothing matches.  A bad draft
    costs nothing but its rows: it is committed only where it equals the
    model's own greedy choice."""
    B, C = ctx.shape
    dev = ctx.device
    bidx = torch.arange(B, device=dev)[:, None]
    # g[:, j] = the (j+1)-th-last committed token
    gpos = ctx_len[:, None] - 1 - torch.arange(N, device=dev)[None, :]
    g = ctx[bidx, gpos.clamp(0, C - 1)]
    gvalid = gpos >= 0
    score = torch.zeros((B, C), dtype=torch.int32, device=dev)
    run = torch.ones((B, C), dtype=torch.bool, device=dev)
    for j in range(N):
        shifted = torch.cat([torch.zeros_like(ctx[:, :j]), ctx[:, :C - j]],
                            dim=1)                                # ctx[t-j]
        run = run & (shifted == g[:, j:j + 1]) & gvalid[:, j:j + 1]
        score = score + run.to(torch.int32)
    t = torch.arange(C, device=dev)[None, :]
    # neither the committed suffix itself nor anything at or after the end
    score = torch.where(t < ctx_len[:, None] - 1, score, 0)
    best = (score * C + t).argmax(dim=1)
    has = score.gather(1, best[:, None]) > 0
    dpos = best[:, None] + 1 + torch.arange(K, device=dev)[None, :]
    draft = ctx[bidx, dpos.clamp(0, C - 1)]
    return torch.where(has & (dpos < C), draft, 0)
