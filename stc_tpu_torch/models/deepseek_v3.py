"""DeepSeek-V3-style decoder with streaming ReKV attention over a latent
store: multi-head latent attention (MLA) and mixture-of-experts MLPs, the
language model of Kimi-VL (``models/kimi_vl.py``).

Attention (absorbed MLA, ``q_lora_rank`` null).  Per token and layer,
``q = x Wq`` gives each head ``q_nope`` (qk_nope_head_dim) and ``q_pe``
(qk_rope_head_dim); ``x W_kva`` gives the compressed KV ``c``
(kv_lora_rank) and ``k_pe``, one per token, shared by the heads.  The
store keeps the row ``[RMSNorm(c) | k_pe]`` unrotated
(``kvcache/latent.py``).  ``kv_b_proj`` is never applied to the rows: its
key half W_UK is absorbed into the query, ``q_abs = q_nope W_UK`` (R wide),
and its value half W_UV into the output, ``o = (softmax . c) W_UV``, then
``o_proj``.  Scores are ``q_abs . c + q_pe . k_pe`` (RoPE on the rope dims
only) at scale (qk_nope_head_dim + qk_rope_head_dim) ** -0.5.  The
checkpoint's rope dims are interleaved pairs (DeepSeek's modelling code
permutes them to halves before a rotate-half); the converter permutes the
rope columns of ``q_proj`` and ``kv_a_proj_with_mqa`` to halves once, so
the rows are stored, and rotated, in rotate-half order.

MLP.  The first ``first_k_dense_replace`` layers are dense SwiGLU; the rest
are MoE: a float32 gate, sigmoid scores, ``noaux_tc`` choice (the
correction bias added for the choice only; one group), top-k through
``ops/topk.py`` (ties to the lower expert), the chosen scores renormalised
(``norm_topk_prob``) and scaled by ``routed_scaling_factor``, plus the
shared experts (one SwiGLU of n_shared_experts x moe_intermediate_size).
The routed experts run with static shapes and no host read, so a CUDA
graph captures the whole append (runtime/graphs.py): an expert sees
at most the append's T tokens, so each expert's index list at capacity T
is every token of the append in order, the experts run as two batched
GEMMs over (n_experts, T) rows, and the gate's zeros drop the tokens an
expert was not chosen for; the weighted sum over experts runs in float32.
Each append records its top-k choices of each layer (``route``; the init
prompt's in ``route_init``).  Each video append adds, on the device, the
tokens each expert took to ``expert_tokens`` (L, n_experts), the experts
it hit (took a token) in each layer to ``expert_hits`` (L,), and one to
``moe_appends`` (``utils.metrics.moe_counts``).

Entry points are ``Qwen2``'s, as the session calls them: ``encode_step``,
``qa_retrieve_step``, ``decode_step``, ``greedy_decode``,
``answer_question``.  Question answering runs on the CPU only
(``kvcache/latent.LATENT_DECODE_ON_CARD``).  Not supported, and refused at
session build (``models/kimi_vl.check_session``): tp / sp / pp, int8 or
int4 pages, int8 weights, speculative decode, the host-side scorers,
window or retrieved-KV compression, ragged appends and host-tier
eviction.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F

from stc_tpu_torch.config import ReKVConfig
from stc_tpu_torch.device import resolve_device
from stc_tpu_torch.kvcache import engine, latent
from stc_tpu_torch.kvcache.state import LatentKV, layer
from stc_tpu_torch.models.qwen2 import Qwen2, rms_norm
from stc_tpu_torch.ops.topk import topk_lowest


@dataclasses.dataclass(frozen=True)
class DeepseekV3Config:
    vocab_size: int = 163840
    hidden_size: int = 2048
    num_layers: int = 27
    num_heads: int = 16
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    kv_lora_rank: int = 512
    intermediate_size: int = 11264
    moe_intermediate_size: int = 1408
    n_routed_experts: int = 64
    num_experts_per_tok: int = 6
    n_shared_experts: int = 2
    first_k_dense_replace: int = 1
    routed_scaling_factor: float = 2.446
    norm_topk_prob: bool = True
    rope_base: float = 800000.0
    rms_eps: float = 1e-5

    @property
    def row_width(self) -> int:
        """Width of a stored latent row: kv_lora_rank + qk_rope_head_dim."""
        return self.kv_lora_rank + self.qk_rope_head_dim

    @property
    def scale(self) -> float:
        return (self.qk_nope_head_dim + self.qk_rope_head_dim) ** -0.5

    @classmethod
    def tiny(cls, vocab=256):
        """Small config for tests: 1 dense + 3 MoE layers, 8 experts top-2."""
        return cls(vocab_size=vocab, hidden_size=64, num_layers=4,
                   num_heads=4, qk_nope_head_dim=16, qk_rope_head_dim=16,
                   v_head_dim=16, kv_lora_rank=32, intermediate_size=128,
                   moe_intermediate_size=32, n_routed_experts=8,
                   num_experts_per_tok=2, n_shared_experts=1,
                   rope_base=10000.0)


def rope_perm(P: int) -> torch.Tensor:
    """Interleaved pairs -> halves: index j of the half layout holds dim
    perm[j] of the interleaved one."""
    return torch.cat([torch.arange(0, P, 2), torch.arange(1, P, 2)])


class DeepseekV3Layer(nn.Module):
    def __init__(self, cfg: DeepseekV3Config, moe: bool, dtype, device):
        super().__init__()
        E, H = cfg.hidden_size, cfg.num_heads
        Dq = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim

        def p(*shape, dt=dtype):
            return nn.Parameter(torch.zeros(shape, dtype=dt, device=device),
                                requires_grad=False)

        self.moe = moe
        self.ln1, self.ln2 = p(E), p(E)
        self.wq = p(E, H * Dq)
        self.w_kva = p(E, cfg.row_width)
        self.kv_ln = p(cfg.kv_lora_rank)
        self.w_uk = p(H, cfg.qk_nope_head_dim, cfg.kv_lora_rank)
        self.w_uv = p(H, cfg.kv_lora_rank, cfg.v_head_dim)
        self.wo = p(H * cfg.v_head_dim, E)
        if not moe:
            F_ = cfg.intermediate_size
            self.w_gateup, self.w_down = p(E, 2 * F_), p(F_, E)
            return
        n, Fe = cfg.n_routed_experts, cfg.moe_intermediate_size
        Fs = Fe * cfg.n_shared_experts
        self.gate_w = p(E, n, dt=torch.float32)
        self.e_bias = p(n, dt=torch.float32)
        self.e_gateup, self.e_down = p(n, E, 2 * Fe), p(n, Fe, E)
        self.s_gateup, self.s_down = p(E, 2 * Fs), p(Fs, E)


def _swiglu(x, w_gateup, w_down):
    g, u = (x @ w_gateup).chunk(2, dim=-1)
    return (F.silu(g) * u) @ w_down


class DeepseekV3(nn.Module):
    """The streaming LM.  Weights start zeroed: fill them with
    init_random_params or convert.convert_deepseek_v3."""

    # the answer loop and the prompt prefill behind it are Qwen2's, over
    # this module's decode_step
    greedy_decode = Qwen2.greedy_decode
    _answer = Qwen2._answer

    def __init__(self, cfg: DeepseekV3Config, dtype=torch.bfloat16,
                 device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        # no parallel layout (kimi_vl.check_session)
        self.mesh = self.tp = self.sp = self.pp = None
        E, V = cfg.hidden_size, cfg.vocab_size

        def p(*shape):
            return nn.Parameter(torch.zeros(shape, dtype=dtype,
                                            device=device),
                                requires_grad=False)

        self.embed = p(V, E)
        self.layers = nn.ModuleList(
            DeepseekV3Layer(cfg, i >= cfg.first_k_dense_replace, dtype,
                            device) for i in range(cfg.num_layers))
        self.norm_f = p(E)
        self.lm_head = p(E, V)
        # the last video append's and init prompt's top-k experts of each
        # layer (L, B * T, k); over the video appends since the last reset,
        # the tokens each expert took (L, n_experts), the experts each
        # layer hit, summed (L,), and the appends; the append's own tokens
        # an expert took (L, n_experts)
        self.route = self.route_init = None
        L, n = cfg.num_layers, cfg.n_routed_experts
        for name, shape in (("expert_tokens", (L, n)), ("expert_hits", (L,)),
                            ("moe_appends", ()), ("_step_tokens", (L, n))):
            self.register_buffer(name, torch.zeros(
                shape, dtype=torch.int64, device=device), persistent=False)

    @property
    def dtype(self):
        return self.norm_f.dtype

    @property
    def device(self):
        return self.norm_f.device

    @torch.no_grad()
    def init_random_params(self, generator: torch.Generator,
                           scale: float = 0.02) -> "DeepseekV3":
        """N(0, 1) * scale matrices and correction biases, unit norms."""
        for name, prm in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("ln1", "ln2", "kv_ln", "norm_f"):
                prm.fill_(1.0)
            else:
                prm.copy_(torch.randn(prm.shape, generator=generator,
                                      device=generator.device) * scale)
        return self

    # ------------------------------------------------------------------ #
    def init_stream_state(self, rekv: ReKVConfig, batch: int,
                          dtype=torch.bfloat16) -> LatentKV:
        return latent.init_latent_kv(rekv, batch, self.cfg.row_width, dtype,
                                     device=self.device,
                                     layers=self.cfg.num_layers)

    def init_decode_state(self, rekv: ReKVConfig, batch: int,
                          dtype=torch.bfloat16):
        return latent.init_latent_decode(rekv, batch, self.cfg.row_width,
                                         dtype, device=self.device,
                                         layers=self.cfg.num_layers)

    def embed_tokens(self, ids: torch.Tensor) -> torch.Tensor:
        return self.embed[ids.to(torch.int64)]

    def _latent_qkv(self, lp: DeepseekV3Layer, x: torch.Tensor):
        """x (B, T, E) normed -> (q_abs (B, T, H, R), q_pe (B, T, H, P),
        rows (B, T, R + P)), all unrotated."""
        c = self.cfg
        B, T, _ = x.shape
        q = (x @ lp.wq).reshape(B, T, c.num_heads, -1)
        q_nope, q_pe = q.split([c.qk_nope_head_dim, c.qk_rope_head_dim], -1)
        q_abs = torch.einsum("bthn,hnr->bthr", q_nope, lp.w_uk)
        ckv, k_pe = (x @ lp.w_kva).split([c.kv_lora_rank,
                                          c.qk_rope_head_dim], -1)
        rows = torch.cat([rms_norm(ckv, lp.kv_ln, c.rms_eps), k_pe], -1)
        return q_abs, q_pe, rows

    def _attn_out(self, lp: DeepseekV3Layer, o_lat: torch.Tensor):
        B, T = o_lat.shape[:2]
        o = torch.einsum("bthr,hrv->bthv", o_lat.to(self.dtype), lp.w_uv)
        return o.reshape(B, T, -1) @ lp.wo

    def route_tokens(self, lp: DeepseekV3Layer, x: torch.Tensor):
        """The router of an MoE layer over tokens x (N, E): (top-k experts
        (N, k) int64, their weights (N, k) float32)."""
        c = self.cfg
        scores = (x.to(torch.float32) @ lp.gate_w).sigmoid()
        _, idx = topk_lowest(scores + lp.e_bias, c.num_experts_per_tok)
        w = scores.gather(1, idx)
        if c.norm_topk_prob:
            w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
        return idx, w * c.routed_scaling_factor

    def _moe(self, i: int, lp: DeepseekV3Layer, x: torch.Tensor, route,
             count: bool):
        """Routed + shared experts of MoE layer i over x (B, T, E) normed.
        The choices go to route[i] (route: a buffer or None) and, with
        count, to the append's _step_tokens[i]."""
        c = self.cfg
        B, T, E = x.shape
        xt = x.reshape(B * T, E)
        idx, w = self.route_tokens(lp, xt)
        if route is not None:
            route[i].copy_(idx)
        if count:
            self._step_tokens[i].scatter_add_(0, idx.reshape(-1),
                                              torch.ones_like(
                                                  idx.reshape(-1)))
        gate = torch.zeros((B * T, c.n_routed_experts), dtype=torch.float32,
                           device=x.device).scatter_(1, idx, w)
        n = c.n_routed_experts
        g, u = torch.bmm(xt.expand(n, -1, -1), lp.e_gateup).chunk(2, -1)
        ye = torch.bmm(F.silu(g) * u, lp.e_down)               # (n, N, E)
        routed = torch.einsum("nte,tn->te", ye.to(torch.float32), gate)
        shared = _swiglu(xt, lp.s_gateup, lp.s_down)
        return (routed.to(x.dtype) + shared).reshape(B, T, E)

    def _ffn(self, i: int, lp: DeepseekV3Layer, h, route=None,
             count: bool = False):
        x = rms_norm(h, lp.ln2, self.cfg.rms_eps)
        if lp.moe:
            return h + self._moe(i, lp, x, route, count)
        return h + _swiglu(x, lp.w_gateup, lp.w_down)

    def _lm_head(self, h):
        return rms_norm(h, self.norm_f, self.cfg.rms_eps) @ self.lm_head

    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def encode_step(self, rekv: ReKVConfig, kvs: LatentKV,
                    embeds: torch.Tensor, *, is_init: bool,
                    active: Optional[torch.Tensor] = None):
        """One streaming append of embeds (B, T, E) through every layer;
        kvs is updated in place.  Returns (final hidden states, kvs)."""
        if active is not None:
            raise ValueError("ragged appends (active=) are not supported "
                             "over a latent store")
        c = self.cfg
        B, T, _ = embeds.shape
        rc = None
        shape = (c.num_layers, B * T, c.num_experts_per_tok)
        if is_init:
            route = self.route_init = torch.zeros(
                shape, dtype=torch.int64, device=embeds.device)
        else:  # position tables are shared by every layer
            rc = engine.make_rope_cache(
                kvs.length[0], kvs.num_blocks[0], T, rekv,
                c.qk_rope_head_dim, c.rope_base, kvs.page_offset[0])
            # a graph's replays write the buffer its capture saw
            if self.route is None or tuple(self.route.shape) != shape:
                self.route = torch.zeros(shape, dtype=torch.int64,
                                         device=embeds.device)
            route = self.route
            self._step_tokens.zero_()
        h = embeds
        for i, lp in enumerate(self.layers):
            q_abs, q_pe, rows = self._latent_qkv(
                lp, rms_norm(h, lp.ln1, c.rms_eps))
            o = latent.append_latent(layer(kvs, i), q_abs, q_pe, rows, rekv,
                                     is_init=is_init, scale=c.scale,
                                     rope_base=c.rope_base, rope_cache=rc)
            h = h + self._attn_out(lp, o)
            h = self._ffn(i, lp, h, route, count=not is_init)
        if not is_init:
            self.expert_tokens += self._step_tokens
            self.expert_hits += (self._step_tokens > 0).sum(dim=-1)
            self.moe_appends += 1
        return h, kvs

    @torch.no_grad()
    def qa_retrieve_step(self, rekv: ReKVConfig, kvs: LatentKV, dkvs,
                         embeds: torch.Tensor,
                         n_tokens: Optional[torch.Tensor] = None,
                         retrieved_indices: Optional[torch.Tensor] = None):
        """Question forward with per-layer retrieval (the mean absorbed
        query of the question against each block's mean row); installs
        each layer's retrieved rows into the decode cache (in place); the
        question's own rows join this forward only.  Returns (dkvs,
        abs_idx (L, B, topk), exists (L, B, topk))."""
        c = self.cfg
        B, T, _ = embeds.shape
        dev = embeds.device
        q_valid = None
        if n_tokens is not None:
            n_tokens = torch.as_tensor(n_tokens, device=dev).expand(B)
            q_valid = torch.arange(T, device=dev)[None, :] < n_tokens[:, None]
        ar = torch.arange(T, device=dev)[None, :]
        picked = []
        h = embeds
        for i, lp in enumerate(self.layers):
            q_abs, q_pe, rows = self._latent_qkv(
                lp, rms_norm(h, lp.ln1, c.rms_eps))
            kv = layer(kvs, i)
            if retrieved_indices is None:
                q = torch.cat([q_abs, q_pe], -1).transpose(1, 2)
                abs_idx, exists = engine.score_blocks(kv, q, rekv, q_valid)
            else:
                abs_idx, exists = engine.external_blocks(kv,
                                                         retrieved_indices)
            picked.append((abs_idx, exists))
            ret, valid_len = latent.retrieve_latent(kv, rekv, abs_idx,
                                                    exists)
            P = c.qk_rope_head_dim
            dl = latent.latent_decode_write(layer(dkvs, i), ret, valid_len,
                                            P, rope_base=c.rope_base,
                                            at_start=True)
            dl_q = latent.latent_decode_write(dl, rows, T, P,
                                              rope_base=c.rope_base)
            o = latent.latent_decode_attend(
                q_abs, q_pe, valid_len[:, None] + ar, dl_q, rekv,
                scale=c.scale, rope_base=c.rope_base)
            dkvs.cursor[i] = valid_len
            h = self._ffn(i, lp, h + self._attn_out(lp, o))
        abs_idx, exists = (torch.stack([p[j] for p in picked]) for j in (0, 1))
        return dkvs, abs_idx, exists

    @torch.no_grad()
    def decode_step(self, rekv: ReKVConfig, dkvs, embeds: torch.Tensor,
                    n_tokens):
        """Prompt prefill (T tokens, n_tokens (B,) valid) or 1-token decode
        over the decode cache.  Returns (logits (B, T, V), dkvs updated in
        place)."""
        c = self.cfg
        T = embeds.shape[1]
        ar = torch.arange(T, device=embeds.device)[None, :]
        h = embeds
        for i, lp in enumerate(self.layers):
            q_abs, q_pe, rows = self._latent_qkv(
                lp, rms_norm(h, lp.ln1, c.rms_eps))
            dl = layer(dkvs, i)
            start = dl.cursor.clone()
            dl = latent.latent_decode_write(dl, rows, n_tokens,
                                            c.qk_rope_head_dim,
                                            rope_base=c.rope_base)
            o = latent.latent_decode_attend(
                q_abs, q_pe, start[:, None] + ar, dl, rekv, scale=c.scale,
                rope_base=c.rope_base)
            dkvs.cursor[i] = dl.cursor
            h = self._ffn(i, lp, h + self._attn_out(lp, o))
        return self._lm_head(h), dkvs

    @torch.no_grad()
    def answer_question(self, rekv: ReKVConfig, kvs: LatentKV,
                        q_ids: torch.Tensor, q_len: torch.Tensor,
                        p_ids: torch.Tensor, p_len: torch.Tensor,
                        stop_ids: torch.Tensor, max_new_tokens: int,
                        retrieved_indices: Optional[torch.Tensor] = None,
                        hist_ids=None, hist_len=None):
        """Retrieval forward + prompt prefill + greedy decode (Qwen2's).
        Returns (tokens, n_generated, abs_idx (L, B, topk), exists)."""
        if kvs.init_c.device.type != "cpu":
            raise NotImplementedError(latent.LATENT_DECODE_ON_CARD)
        dkvs = self.init_decode_state(rekv, q_ids.shape[0],
                                      kvs.init_c.dtype)
        dkvs, abs_idx, exists = self.qa_retrieve_step(
            rekv, kvs, dkvs, self.embed_tokens(q_ids), n_tokens=q_len,
            retrieved_indices=retrieved_indices)
        tokens, count = self._answer(rekv, dkvs, q_ids, q_len, p_ids, p_len,
                                     stop_ids, max_new_tokens, hist_ids,
                                     hist_len)
        return tokens, count, abs_idx, exists
