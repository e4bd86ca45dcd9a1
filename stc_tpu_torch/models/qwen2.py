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
  greedy_decode     the answer loop, never emitting a stop token first
  answer_question   retrieval + prefill + greedy decode
  answer_question_hosttier  one round of the two-tier QA: the retrieval
                    forward, then prefill and decode only if every
                    selected page was served (with `stage`, a layer whose
                    selection missed has its pages staged before it goes
                    on, so the round serves everything)

``Qwen2.quantize_int8`` turns the weights into int8 with float32 scales
(``stc_tpu``'s ``quantize_params_int8``); every matmul then dequantizes its
weight inside the call, at ``stc_tpu``'s rounding points (``_mm``).
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
        self.cfg = cfg
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
        return self._mm(o.transpose(1, 2).reshape(B, T, Hq * D), lp, "wo")

    def _mlp(self, lp: Qwen2Layer, h):
        g, u = self._mm(h, lp, "w_gateup").chunk(2, dim=-1)
        return self._mm(F.silu(g) * u, lp, "w_down")

    def _finish_layer(self, lp: Qwen2Layer, h, o):
        """Attention output projection and residual, then the MLP."""
        h = h + self._proj_out(lp, o)
        return h + self._mlp(lp, rms_norm(h, lp.ln2, self.cfg.rms_eps))

    def _lm_head(self, h):
        return self._mm(rms_norm(h, self.norm_f, self.cfg.rms_eps), self,
                        "lm_head")

    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def encode_step(self, rekv: ReKVConfig, kvs: StreamKV,
                    embeds: torch.Tensor, *, is_init: bool,
                    active: Optional[torch.Tensor] = None):
        """One streaming append of embeds (B, T, E) through every layer;
        kvs is updated in place.  active: optional (B,) bool ragged mask,
        inactive streams' state untouched (engine.append_stream).  Returns
        (final hidden states, kvs)."""
        c = self.cfg
        rc = None
        if not is_init:  # position tables are shared by every layer
            rc = engine.make_rope_cache(
                kvs.length[0], kvs.num_blocks[0], embeds.shape[1], rekv,
                c.head_dim, c.rope_base, kvs.page_offset[0])
        h = embeds
        for i, lp in enumerate(self.layers):
            q, k, v = self._qkv(lp, rms_norm(h, lp.ln1, c.rms_eps))
            o, _ = engine.append_stream(layer(kvs, i), q, k, v, rekv,
                                        is_init=is_init,
                                        rope_base=c.rope_base, rope_cache=rc,
                                        active=active)
            h = self._finish_layer(lp, h, o)
        return h, kvs

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
        q_valid = None
        if n_tokens is not None:
            n_tokens = torch.as_tensor(n_tokens, device=dev).expand(B)
            q_valid = torch.arange(T, device=dev)[None, :] < n_tokens[:, None]
        raw_rows = rekv.n_init if rekv.decode_cap > rekv.n_local else 0
        ar = torch.arange(T, device=dev)[None, :]
        h, picked = embeds, []
        for i, lp in enumerate(self.layers):
            q, k, v = self._qkv(lp, rms_norm(h, lp.ln1, c.rms_eps))
            kv = layer(kvs, i)
            if retrieved_indices is None:
                abs_idx, exists = engine.score_blocks(kv, q, rekv, q_valid)
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
            dkv = engine.decode_write(layer(dkvs, i), ret_k, ret_v, valid_len,
                                      at_start=True, rope_base=c.rope_base,
                                      raw_rows=raw_rows)
            # the question's KV join this forward only: cursor resets after
            dkv_q = engine.decode_write(dkv, k, v, T, rope_base=c.rope_base)
            o = engine.decode_attend(q, valid_len[:, None] + ar, dkv_q, rekv,
                                     rope_base=c.rope_base)
            dkvs.cursor[i] = valid_len
            h = self._finish_layer(lp, h, o)
        abs_idx, exists = (torch.stack([p[j] for p in picked])
                           for j in (0, 1))
        missing = (None if host_pages is None
                   else torch.stack([p[2] for p in picked]))
        return dkvs, abs_idx, exists, missing

    @torch.no_grad()
    def decode_step(self, rekv: ReKVConfig, dkvs: DecodeKV,
                    embeds: torch.Tensor, n_tokens):
        """Prompt prefill (T tokens, n_tokens (B,) valid) or 1-token decode.
        Returns (logits (B, T, V), dkvs updated in place)."""
        c = self.cfg
        B, T, _ = embeds.shape
        ar = torch.arange(T, device=embeds.device)[None, :]
        h = embeds
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
        return self._lm_head(h), dkvs

    @torch.no_grad()
    def greedy_decode(self, rekv: ReKVConfig, dkvs: DecodeKV,
                      last_logits: torch.Tensor, stop_ids: torch.Tensor,
                      max_new_tokens: int):
        """Greedy decode from the prompt's last logits (B, V); step 0 never
        emits a stop token (top-2 fallback).  stop_ids: (n,) int32, -1
        padded.  Returns (tokens (B, max_new_tokens) int32, n_generated
        (B,) int32, dkvs); every loop step runs one decode_step, and the
        loop stops once every stream has emitted a stop token."""
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
            top2 = torch.topk(logits, 2, dim=-1).indices.to(torch.int32)
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
    def answer_question(self, rekv: ReKVConfig, kvs: StreamKV,
                        q_ids: torch.Tensor, q_len: torch.Tensor,
                        p_ids: torch.Tensor, p_len: torch.Tensor,
                        stop_ids: torch.Tensor, max_new_tokens: int,
                        retrieved_indices: Optional[torch.Tensor] = None):
        """Retrieval forward + prompt prefill + greedy decode.  Returns
        (tokens, n_generated, abs_idx (L, B, topk), exists)."""
        B = q_ids.shape[0]
        dkvs = self.init_decode_state(rekv, B, kvs.init_k.dtype)
        dkvs, abs_idx, exists = self.qa_retrieve_step(
            rekv, kvs, dkvs, self.embed_tokens(q_ids), n_tokens=q_len,
            retrieved_indices=retrieved_indices)
        tokens, count = self._answer(rekv, dkvs, p_ids, p_len, stop_ids,
                                     max_new_tokens)
        return tokens, count, abs_idx, exists

    @torch.no_grad()
    def answer_question_hosttier(self, rekv: ReKVConfig, kvs: StreamKV,
                                 q_ids, q_len, p_ids, p_len, stop_ids,
                                 max_new_tokens: int, hp_kv, hp_ids,
                                 retrieved_indices=None, stage=None):
        """One round of the two-tier QA: the retrieval forward over the
        store and the prefetch table (with `stage`, layer by layer, see
        qa_retrieve_hosttier_step), then -- only when no layer missed a
        selected page (one host read of `missing`) -- prompt prefill and
        greedy decode; a miss round returns zero tokens.  Returns (tokens,
        n_generated, abs_idx, exists, missing)."""
        B = q_ids.shape[0]
        dkvs = self.init_decode_state(rekv, B, kvs.init_k.dtype)
        dkvs, abs_idx, exists, missing = self.qa_retrieve_hosttier_step(
            rekv, kvs, dkvs, self.embed_tokens(q_ids), q_len, hp_kv, hp_ids,
            retrieved_indices=retrieved_indices, stage=stage)
        if bool(missing.any()):
            z = torch.zeros((B, max_new_tokens), dtype=torch.int32,
                            device=q_ids.device)
            return z, z[:, 0], abs_idx, exists, missing
        tokens, count = self._answer(rekv, dkvs, p_ids, p_len, stop_ids,
                                     max_new_tokens)
        return tokens, count, abs_idx, exists, missing

    def _answer(self, rekv, dkvs, p_ids, p_len, stop_ids, max_new_tokens):
        """Prompt prefill over the installed decode cache, then greedy
        decode: (tokens, n_generated)."""
        B = p_ids.shape[0]
        logits, dkvs = self.decode_step(rekv, dkvs, self.embed_tokens(p_ids),
                                        p_len)
        bidx = torch.arange(B, device=logits.device)
        last = logits[bidx, p_len.to(torch.int64) - 1]
        tokens, count, _ = self.greedy_decode(rekv, dkvs, last, stop_ids,
                                              max_new_tokens)
        return tokens, count
