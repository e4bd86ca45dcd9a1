"""Streaming session runtime (port of ``stc_tpu/runtime/session.py``): the
plug-and-play API

    clear_cache() / encode_init_prompt(ids) / encode_video_features(feats)
    / question_answering(...) / question_answering_batch(...)
    / reset_streams(slots) / serve(...) / set_spec_decode(...)
    / encode_video(frames), through an attached frame_encoder

over one device-resident page store for B streams, with a host tier behind
it.  Streams may tick at different rates (``active`` masks: ragged
ingest), slots may be recycled for new streams, and questions may differ
per stream or name their blocks (external retrieval).  A stream past
max_blocks offloads its oldest pages to host memory (kvcache/host_tier.py);
a question whose top-k hits them stages them back and is answered in at
most two retrieval rounds, exactly as an all-device session would answer.
With ``weights_quant`` set, the session quantizes the LM it is given to
int8 at build (in place).  ``serve`` runs a serving tick: a ragged encode
and per-stream questions over the state after it (the ServingEngine of
runtime/serving.py drives it).  With ReKVConfig.spec_decode_draft > 0 the
answers decode speculatively by prompt lookup (the same tokens as greedy),
drafting also from each stream's earlier questions and answers
(spec_history_tokens).  With a host-side block scorer
(ReKVConfig.retrieval_scorer 'aks', 'dpc_knn' or 'l2norm') a question runs
the layerwise retrieval forward: the device computes a layer's rep
logits, the scorer picks its blocks on the host, and host-tier pages it
picks are fetched, layer by layer (one host round trip a layer).  Left out
until its ROADMAP.md item lands: meshes.  stc_tpu's measured-cost router
between one merged XLA program and two is a TPU dispatch mechanism the port
does not keep: ``serve`` always takes its serve path where that path is
eligible.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from stc_tpu_torch.compress.scoring import select_blocks
from stc_tpu_torch.config import SessionConfig
from stc_tpu_torch.kvcache import engine, host_tier
from stc_tpu_torch.kvcache.state import layer
from stc_tpu_torch.models import qwen2 as qw
from stc_tpu_torch.models.qwen2 import Qwen2
from stc_tpu_torch.ops.stream_attention import dequant_rows


def _bucket(n: int, cap: int) -> int:
    b = 8
    while b < n:
        b *= 2
    return min(b, cap)


def _stop_arr(stop_token_ids) -> np.ndarray:
    """Fixed-width stop-token operand, -1 padded."""
    arr = np.full((max(4, len(stop_token_ids)),), -1, np.int32)
    arr[:len(stop_token_ids)] = np.asarray(list(stop_token_ids), np.int32)
    return arr


class StreamingSession:
    def __init__(self, lm: Qwen2, session_cfg: SessionConfig, batch: int = 1,
                 state_dtype=torch.bfloat16, frame_encoder=None):
        """frame_encoder: optional callable frames -> pruned features
        (B, n_frames * block_size, E) (models/llava_onevision.FrameEncoder)
        that encode_video runs; clear_cache resets it when it has a
        reset()."""
        if session_cfg.weights_quant != "none":
            # in place, as stc_tpu's session quantizes its params at build
            lm.quantize_int8(session_cfg.weights_quant_group)
        self.lm = lm
        self.mcfg = lm.cfg
        self.scfg = session_cfg
        self.rekv = rc = session_cfg.rekv
        self.batch = batch
        self.state_dtype = state_dtype
        self.device = lm.device
        self.frame_encoder = frame_encoder
        if rc.retrieve_len > rc.n_init + rc.n_local:
            raise ValueError(
                f"retrieve_len={rc.retrieve_len} exceeds n_init + n_local = "
                f"{rc.n_init + rc.n_local}: retrieved blocks beyond the "
                "local window can never be attended. Lower topk or raise "
                "n_local.")
        self._window_pages = engine.n_window_pages(rc)
        # eviction quantum: a quarter of the store, but never so much that
        # the local window would leave the device
        self._evict_n = min(rc.max_blocks // 4,
                            rc.max_blocks - self._window_pages)
        # prefetch-table cap in columns per (layer, stream), checked when a
        # question starts (a question's miss rounds may grow past it)
        self._hp_cap = max(2 * rc.topk, 64)
        # per-layer block indices chosen by the last QA: stream 0's list
        # at batch 1, one list per stream above
        self.last_retrieved_indices = None
        self.qa_rounds = 0       # retrieval forwards of the last QA
        self.repair_layers = 0   # layers staged inside its second round
        self.staged_bytes = 0    # host-tier bytes staged to the device
        # whether the last serve() took the serve path (observability)
        self.last_serve_fused = False
        self.kvs = None
        self.clear_cache()

    def clear_cache(self):
        self.kvs = self.lm.init_stream_state(self.rekv, self.batch,
                                             self.state_dtype)
        self.host_store = host_tier.HostBlockStore()
        self._staged = None  # eviction staging buffers, made once
        self.hp_reset()
        self._total_blocks = 0   # the longest stream's blocks
        self._init_len = 0       # n_init once the init prompt is encoded
        # per-stream block counts of ragged ingest
        self._stream_blocks = np.zeros(self.batch, dtype=np.int64)
        self._ragged = False
        self._evicted_pages = 0
        # the speculative decode's draft history: the most recent
        # spec_history_tokens question, prompt and answer tokens of each
        # stream (draft material only, never output)
        H = self.rekv.spec_history_tokens if self.rekv.spec_decode_draft \
            else 0
        self._qa_hist = np.zeros((self.batch, H), dtype=np.int32)
        self._qa_hist_len = np.zeros(self.batch, dtype=np.int32)
        if hasattr(self.frame_encoder, "reset"):
            self.frame_encoder.reset()

    # ------------------------------------------------------------------ #
    def _check_rep_capacity(self, incoming_blocks: int):
        """The rep keys score the FULL block history (host tier included);
        past rep_cap new blocks would overwrite the last rep slot.  Fail
        fast."""
        rc = self.rekv
        if self._total_blocks + incoming_blocks > rc.rep_cap:
            raise RuntimeError(
                f"stream exceeds rep-key capacity: {self._total_blocks} + "
                f"{incoming_blocks} blocks > rep_cap={rc.rep_cap}. Set "
                "ReKVConfig.max_rep_blocks to at least the number of frames "
                "in the stream.")

    def _maybe_evict(self, incoming_blocks: int):
        """Offload the oldest device pages to the host tier before they
        would overflow the store.  Every ingest path funnels through here,
        so the rep-capacity check lives here too."""
        self._check_rep_capacity(incoming_blocks)
        rc = self.rekv
        while (self._total_blocks - self._evicted_pages
               + incoming_blocks > rc.max_blocks):
            if self._ragged and np.ptp(self._stream_blocks) > 0:
                raise RuntimeError(
                    "host-tier eviction with diverged ragged streams is not "
                    "supported: eviction shifts every stream's pages "
                    "uniformly, which would evict unwritten slots of the "
                    f"shorter streams (per-stream blocks: "
                    f"{self._stream_blocks.tolist()}). Raise max_blocks to "
                    "cover the longest stream.")
            E = self._evict_n
            resident = self._total_blocks - self._evicted_pages
            if E <= 0 or resident - E < self._window_pages:
                raise RuntimeError(
                    f"max_blocks={rc.max_blocks} leaves no eviction margin "
                    f"over the {self._window_pages}-page window")
            self._evict(E)

    def _evict(self, E: int):
        kvs, rc = self.kvs, self.rekv
        store = self.host_store
        if rc.kv_quant == "none" and rc.host_kv_quant != "none":
            # quantize on the device: the copy to the host is compressed
            qfn = (host_tier.quantize_pages_int4
                   if rc.host_kv_quant == "int4" else host_tier.quantize_pages)
            kq, ks, vq, vs = qfn(kvs.block_k[:, :, :, :E],
                                 kvs.block_v[:, :, :, :E])
            host_tier.evict_pages(kvs, E, None)
            store.append(kq, vq, ks, vs)
        else:
            # the pages as stored (a kv_quant store's with their scales)
            src = [kvs.block_k, kvs.block_v]
            if rc.kv_quant != "none":
                src += [kvs.block_k_scale, kvs.block_v_scale]
            if self._staged is None:
                self._staged = [torch.empty_like(x[:, :, :, :E]) for x in src]
            store.wait_copies()  # the last copy out of the staging is done
            staged = host_tier.evict_pages(kvs, E, self._staged)
            store.append(*staged)
        self._evicted_pages += E

    def _ensure_ragged(self):
        """Adopt the uniform history as per-stream counters."""
        if not self._ragged:
            self._stream_blocks[:] = self._total_blocks
            self._ragged = True

    def _track_blocks(self, n: int, active=None):
        if active is None:
            self._total_blocks += n
            self._stream_blocks += n
            return
        self._ensure_ragged()
        self._stream_blocks += n * np.asarray(active, dtype=np.int64)
        self._total_blocks = int(self._stream_blocks.max())

    def _normalize_active(self, active):
        """-> (device bool (B,) or None, numpy bool (B,) or None); an
        all-True mask is the uniform path (None)."""
        if active is None:
            return None, None
        a = np.asarray(active, dtype=bool).reshape(-1)
        if a.shape != (self.batch,):
            raise ValueError(f"active mask of shape {a.shape} for "
                             f"{self.batch} streams")
        if a.all():
            return None, None
        return torch.as_tensor(a, device=self.device), a

    def _ids(self, arr) -> torch.Tensor:
        return torch.as_tensor(np.array(arr, np.int32), device=self.device)

    def encode_init_prompt(self, init_prompt_ids: Sequence[int]):
        ids = np.asarray(init_prompt_ids, dtype=np.int32).reshape(1, -1)
        ids = np.broadcast_to(ids, (self.batch, ids.shape[1]))
        if ids.shape[1] != self.rekv.n_init:
            raise ValueError(
                f"init prompt must be exactly n_init={self.rekv.n_init} "
                f"tokens, got {ids.shape[1]}")
        self.lm.encode_step(self.rekv, self.kvs,
                            self.lm.embed_tokens(self._ids(ids)),
                            is_init=True)
        self._init_len = self.rekv.n_init

    def encode_video_features(self, feats, active=None):
        """feats: (B, n_frames * block_size, E) pruned visual features;
        one attention call per exc_block_size tokens.  active: optional
        (B,) bool ragged mask: inactive streams' rows are ignored and their
        state stays bit-identical.  Streams whose lengths diverged must
        stay within the device store (eviction shifts every stream)."""
        feats = torch.as_tensor(feats, device=self.device).to(self.lm.dtype)
        B, T, E = feats.shape
        S, exc = self.rekv.block_size, self.rekv.exc_block_size
        if T % S:
            raise ValueError((T, S))
        act_dev, act_np = self._normalize_active(active)
        self._check_rep_capacity(T // S)
        for i in range(0, T, exc):
            n = min(exc, T - i) // S
            self._maybe_evict(n)
            self.lm.encode_step(self.rekv, self.kvs, feats[:, i:i + n * S],
                                is_init=False, active=act_dev)
            self._track_blocks(n, act_np)

    def encode_video(self, frames):
        """frames: (n_frames, H, W, 3) uint8, one chunk through the attached
        frame_encoder, then encode_video_features.  VLMSession overrides
        it with its own vision path."""
        if self.frame_encoder is None:
            raise RuntimeError("encode_video on a bare StreamingSession "
                               "needs a frame_encoder")
        self.encode_video_features(self.frame_encoder(frames))

    # ------------------------------------------------------------------ #
    def question_answering(self, question_ids: Sequence[int],
                           prompt_ids: Sequence[int],
                           stop_token_ids: Sequence[int],
                           max_new_tokens: int = 128,
                           retrieved_indices: Optional[Sequence[int]] = None,
                           all_streams: bool = False):
        """Retrieve with question_ids (or the external block indices
        retrieved_indices, padded or cut to topk), then greedy-decode from
        prompt_ids.  Returns stream 0's answer ids, or with all_streams one
        list per stream (the question is shared; retrieval and answers are
        per stream)."""
        B = self.batch
        q_ids, q_len = self._pad_ids([question_ids] * B)
        p_ids, p_len = self._pad_ids([prompt_ids] * B)
        tokens, count = self._qa_run(q_ids, q_len, p_ids, p_len,
                                     stop_token_ids, max_new_tokens,
                                     retrieved_indices)
        if all_streams:
            return [[int(t) for t in tokens[b, :int(count[b])]]
                    for b in range(B)]
        return [int(t) for t in tokens[0, :int(count[0])]]

    def question_answering_batch(
            self, questions: Sequence[Sequence[int]],
            prompts: Sequence[Sequence[int]], stop_token_ids: Sequence[int],
            max_new_tokens: int = 128,
            retrieved_indices: Optional[Sequence[int]] = None,
            asked=None) -> List[List[int]]:
        """One question and prompt per stream (lengths may differ; they are
        right-padded to a shared bucket), answered in one batched QA.
        asked: optional (B,) bool, the streams that really asked (the
        others' placeholder rows stay out of the draft history).  Returns
        one answer list per stream."""
        if len(questions) != self.batch or len(prompts) != self.batch:
            raise ValueError(f"{len(questions)} questions and "
                             f"{len(prompts)} prompts for {self.batch} "
                             "streams")
        q_ids, q_len = self._pad_ids(questions)
        p_ids, p_len = self._pad_ids(prompts)
        tokens, count = self._qa_run(q_ids, q_len, p_ids, p_len,
                                     stop_token_ids, max_new_tokens,
                                     retrieved_indices, hist_rows=asked)
        return [[int(t) for t in tokens[b, :int(count[b])]]
                for b in range(self.batch)]

    def serve(self, feats, active, questions, prompts, stop_token_ids,
              max_new_tokens: int = 128, asked=None):
        """A serving tick: encode `feats` (B, T, E) into the `active`
        streams ((B,) bool or None for all; inactive rows are ignored), then
        answer per-stream `questions` / `prompts` over the state after the
        encode, so a stream may encode, answer, both or neither.  Streams
        that asked nothing still get rows, to be ignored; asked (B,) bool
        keeps those rows out of the draft history.  last_serve_fused
        reports whether the tick was one stc_tpu would fuse into one
        program (one attention call of the encode, T <= exc_block_size;
        the mean_dot scorer; nothing evicted; room in the store); the port
        runs the same calls either way.  Returns (tokens (B, M), count
        (B,)) as numpy."""
        feats = torch.as_tensor(feats, device=self.device).to(self.lm.dtype)
        T = feats.shape[1]
        if T % self.rekv.block_size:
            raise ValueError((T, self.rekv.block_size))
        self.last_serve_fused = self._serve_eligible(
            T, T // self.rekv.block_size)
        self.encode_video_features(feats, active=active)
        return self._qa_tick(questions, prompts, stop_token_ids,
                             max_new_tokens, asked)

    def _qa_tick(self, questions, prompts, stop_token_ids, max_new_tokens,
                 asked):
        q_ids, q_len = self._pad_ids(questions)
        p_ids, p_len = self._pad_ids(prompts)
        return self._qa_run(q_ids, q_len, p_ids, p_len, stop_token_ids,
                            max_new_tokens, hist_rows=asked)

    def _serve_eligible(self, T: int, n: int) -> bool:
        rc = self.rekv
        return (T <= rc.exc_block_size and rc.retrieval_scorer == "mean_dot"
                and self._evicted_pages == 0
                and self._total_blocks + n <= rc.max_blocks)

    def _pad_ids(self, seqs):
        """Right-pad B token sequences to a shared power-of-two bucket."""
        lens = np.asarray([len(s) for s in seqs], np.int32)
        b = _bucket(int(lens.max()), self.rekv.max_prompt_tokens)
        if int(lens.max()) > b:
            raise ValueError((lens, self.rekv.max_prompt_tokens))
        arr = np.zeros((self.batch, b), dtype=np.int32)
        for i, s in enumerate(seqs):
            arr[i, :len(s)] = np.asarray(list(s), dtype=np.int32)
        return arr, lens

    def _qa_run(self, q_ids, q_len, p_ids, p_len, stop_token_ids,
                max_new_tokens: int, retrieved_indices=None,
                hist_rows=None):
        """Retrieval + prefill + greedy decode, from the device store alone
        or, once pages were evicted, from both tiers.  hist_rows: optional
        (B,) bool, the streams whose question joins the draft history (all
        when None).  Returns (tokens (B, M), count (B,)) as numpy."""
        rc, B = self.rekv, self.batch
        ext = None
        if retrieved_indices is not None:
            arr = np.full((B, rc.topk), -1, dtype=np.int32)
            ids = list(retrieved_indices)[:rc.topk]
            arr[:, :len(ids)] = np.asarray(ids, dtype=np.int32)
            ext = arr
        args = (self._ids(q_ids), self._ids(q_len), self._ids(p_ids),
                self._ids(p_len), self._ids(_stop_arr(stop_token_ids)),
                max_new_tokens)
        if rc.retrieval_scorer != "mean_dot" and ext is None:
            # host-side scorers: layer by layer, host-tier pages included
            dkvs = self._qa_retrieve_layerwise(q_ids, q_len)
            tokens, count = self.lm._answer(rc, dkvs, *args,
                                            **self._hist_kw())
            self.qa_rounds = 1
            return self._qa_finish(q_ids, q_len, p_ids, p_len, tokens,
                                   count, hist_rows)
        if self._evicted_pages > 0:
            tokens, count, abs_idx, exists = self._qa_hosttier(args, ext)
        else:
            tokens, count, abs_idx, exists = self.lm.answer_question(
                self.rekv, self.kvs, *args,
                retrieved_indices=None if ext is None else self._ids(ext),
                **self._hist_kw())
            self.qa_rounds = 1
        self._set_retrieved(abs_idx.cpu().numpy(), exists.cpu().numpy())
        return self._qa_finish(q_ids, q_len, p_ids, p_len, tokens, count,
                               hist_rows)

    def _set_retrieved(self, a, e):
        """last_retrieved_indices from abs_idx / exists (L, B, topk): each
        layer's blocks, stream 0's at batch 1, one list per stream
        above."""
        per = [[[int(i) for i in a[l, b][e[l, b]]]
                for b in range(self.batch)] for l in range(a.shape[0])]
        self.last_retrieved_indices = (per if self.batch > 1
                                       else [p[0] for p in per])

    def _qa_finish(self, q_ids, q_len, p_ids, p_len, tokens, count,
                   hist_rows):
        tokens, count = tokens.cpu().numpy(), count.cpu().numpy()
        self._hist_append(q_ids, q_len, p_ids, p_len, tokens, count,
                          rows=hist_rows)
        return tokens, count

    def _qa_retrieve_layerwise(self, q_ids, q_len):
        """Question forward with host-side block selection, layer by layer
        (stc_tpu's _qa_retrieve_layerwise): the device computes a layer's
        rep logits and mean query, the configured scorer (select_blocks)
        picks each stream's blocks among its own real ones on the host,
        host-tier pages it picks are fetched, and the layer attends them.
        One host round trip a layer.  Sets last_retrieved_indices; returns
        the decode state with each layer's retrieved prefix installed."""
        rc, mc, B = self.rekv, self.mcfg, self.batch
        dev, dt = self.device, self.kvs.init_k.dtype
        S, Hkv, D = rc.block_size, mc.num_kv_heads, mc.head_dim
        G = mc.num_heads // Hkv
        n_tok = self._ids(np.broadcast_to(np.asarray(q_len, np.int32), (B,)))
        h = self.lm.embed_tokens(self._ids(q_ids))
        dkvs = self.lm.init_decode_state(rc, B, dt)
        seed = qw.compress_seed(rc, self.kvs)
        # per-stream block counts: ragged or recycled slots hold fewer
        # blocks than the longest stream and score only their own
        nbs = [int(self._stream_blocks[b]) if self._ragged
               else self._total_blocks for b in range(B)]
        picks = np.full((mc.num_layers, B, rc.topk), -1, np.int32)
        for l in range(mc.num_layers):
            kv = layer(self.kvs, l)
            q, k, v, logits, _, q_mean = self.lm.qa_layer_logits(
                l, rc, kv, h, n_tok)
            n_max = max(nbs)
            logits_np = logits[:, :n_max].float().cpu().numpy()
            reps_np = kv.block_rep[:, :n_max].float().cpu().numpy()
            q_mean_np = q_mean.float().cpu().numpy()
            arr = picks[l]
            for b, nb in enumerate(nbs):
                if nb == 0:
                    continue
                reps_flat = np.repeat(reps_np[b, :nb], G,
                                      axis=1).reshape(nb, -1)
                idx = select_blocks(rc.retrieval_scorer, logits_np[b, :nb],
                                    reps_flat, q_mean_np[b].reshape(-1),
                                    rc.topk, rc.chunk_size)
                arr[b, :len(idx)] = np.asarray(idx, np.int32)
            use_host = (arr >= 0) & (arr < self._evicted_pages)
            host_k = torch.zeros((B, rc.topk, Hkv, S, D), dtype=dt,
                                 device=dev)
            host_v = torch.zeros_like(host_k)
            for b in range(B):
                if use_host[b].any():
                    hk, hv = self.host_store.fetch(l, b, arr[b][use_host[b]])
                    cols = torch.as_tensor(np.nonzero(use_host[b])[0],
                                           device=dev)
                    host_k[b, cols] = hk.to(device=dev, dtype=dt)
                    host_v[b, cols] = hv.to(device=dev, dtype=dt)
            h, cur = self.lm.qa_layer_attend(
                l, rc, kv, layer(dkvs, l), h, q, k, v, self._ids(arr),
                torch.as_tensor(arr >= 0, device=dev),
                torch.as_tensor(use_host, device=dev), host_k, host_v,
                qw.compress_generator(seed, dev))
            dkvs.cursor[l] = cur
        self._set_retrieved(picks, picks >= 0)
        return dkvs

    # ------------------------------------------------------------------ #
    def set_spec_decode(self, draft: int,
                        history_tokens: Optional[int] = None):
        """Turn prompt-lookup speculative decoding on (draft tokens a
        round) or off (0) on the live session, stream state untouched: the
        answers are greedy's either way.  history_tokens: the draft
        history's length per stream (None keeps the config's).  The
        history ring is resized; its most recent tokens survive."""
        kw = dict(spec_decode_draft=draft)
        if history_tokens is not None:
            kw["spec_history_tokens"] = history_tokens
        self.rekv = rc = dataclasses.replace(self.rekv, **kw)
        self.scfg = dataclasses.replace(self.scfg, rekv=rc)
        H = rc.spec_history_tokens if draft else 0
        if H != self._qa_hist.shape[1]:
            old, old_len = self._qa_hist, self._qa_hist_len
            self._qa_hist = np.zeros((self.batch, H), dtype=np.int32)
            self._qa_hist_len = np.zeros(self.batch, dtype=np.int32)
            keep = min(H, old.shape[1])
            if keep:
                for b in range(self.batch):
                    n = min(int(old_len[b]), keep)
                    self._qa_hist[b, :n] = old[b, int(old_len[b]) - n:
                                               int(old_len[b])]
                    self._qa_hist_len[b] = n

    def _hist_kw(self):
        """The draft history for the QA calls ({} when it is off)."""
        if self._qa_hist.shape[1] == 0:
            return {}
        return dict(hist_ids=self._ids(self._qa_hist),
                    hist_len=self._ids(self._qa_hist_len))

    def _hist_append(self, q_ids, q_len, p_ids, p_len, tokens, count,
                     rows=None):
        """Record each stream's question, prompt and answer tokens in its
        draft history, most recent kept; rows: optional (B,) bool mask of
        the streams to record."""
        H = self._qa_hist.shape[1]
        if H == 0:
            return
        q_len, p_len = np.asarray(q_len), np.asarray(p_len)
        for b in range(self.batch):
            if rows is not None and not rows[b]:
                continue
            seq = np.concatenate([
                np.asarray(q_ids[b, :q_len[b]], np.int32),
                np.asarray(p_ids[b, :p_len[b]], np.int32),
                np.asarray(tokens[b, :int(count[b])], np.int32)])[-H:]
            n, L = len(seq), int(self._qa_hist_len[b])
            if L + n > H:
                shift = L + n - H
                self._qa_hist[b, :L - shift] = self._qa_hist[b, shift:L]
                L -= shift
            self._qa_hist[b, L:L + n] = seq
            self._qa_hist_len[b] = L + n

    # ------------------------------------------------------------------ #
    def hp_reset(self):
        """Drop the prefetch table (host pages staged on the device)."""
        self._hp_cols = {}     # (layer, b) -> {abs page: table column}
        self._hp_pending = []  # (layer, b, col, page, k, v, scales or None)
        self._hp_dev = None    # (hp_kv (2, L, B, Hkv, M, S, D), hp_ids)

    def _hp_fetch(self, layer: int, b: int, ids):
        """Pull host pages, as stored, and queue them for the table."""
        cols = self._hp_cols.setdefault((layer, b), {})
        need = [int(i) for i in ids if int(i) not in cols]
        if not need:
            return
        hk, hv, hks, hvs = self.host_store.fetch_raw(layer, b, need)
        for j, p in enumerate(need):
            col = len(cols)
            cols[p] = col
            sc = None if hks is None else torch.stack([hks[j], hvs[j]])
            self._hp_pending.append((layer, b, col, p, hk[j], hv[j], sc))

    def _to_device(self, parts: List[torch.Tensor]) -> torch.Tensor:
        """Stack host tensors on the device: through one pinned buffer and
        an asynchronous copy on the card."""
        if self.device.type == "cpu":
            out = torch.stack(parts)
            self.staged_bytes += out.numel() * out.element_size()
            return out
        buf = torch.empty((len(parts),) + tuple(parts[0].shape),
                          dtype=parts[0].dtype, pin_memory=True)
        torch.stack(parts, out=buf)
        self.staged_bytes += buf.numel() * buf.element_size()
        return self._h2d(buf)

    def _h2d(self, buf: torch.Tensor) -> torch.Tensor:
        """The copy of a pinned host buffer to the device, on the current
        stream (its own method, so a measurement can time it)."""
        return buf.to(self.device, non_blocking=True)

    def _hp_device(self):
        """The prefetch table on the device, with the pending pages
        scattered in (dequantized there): (hp_kv (2, L, B, Hkv, M, S, D),
        hp_ids (L, B, M) int32, int32-max padded).  The table only grows;
        M is bucketed to powers of two."""
        rc, mc = self.rekv, self.mcfg
        L, B = mc.num_layers, self.batch
        S, Hkv, D = rc.block_size, mc.num_kv_heads, mc.head_dim
        longest = max([len(c) for c in self._hp_cols.values()] or [0])
        M = _bucket(max(longest, 1), 1 << 30)
        dt, dev = self.kvs.init_k.dtype, self.device
        imax = torch.iinfo(torch.int32).max
        if self._hp_dev is None or M > self._hp_dev[1].shape[-1]:
            kv = torch.zeros((2, L, B, Hkv, M, S, D), dtype=dt, device=dev)
            ids = torch.full((L, B, M), imax, dtype=torch.int32, device=dev)
            if self._hp_dev is not None:
                old_kv, old_ids = self._hp_dev
                m = old_ids.shape[-1]
                kv[:, :, :, :, :m] = old_kv
                ids[:, :, :m] = old_ids
            self._hp_dev = (kv, ids)
        kv, ids = self._hp_dev
        if self._hp_pending:
            pend = self._hp_pending
            delta = self._to_device([torch.stack([k, v])
                                     for (_, _, _, _, k, v, _) in pend])
            coords = torch.as_tensor([(l, b, c, p) for (l, b, c, p, *_)
                                      in pend], dtype=torch.int64,
                                     device=dev)
            if pend[0][6] is not None:  # quantized: dequantize here
                scales = self._to_device([s for (*_, s) in pend])
                delta = dequant_rows(delta, scales[:, :, :, None, :])
            li, bi, ci = coords[:, 0], coords[:, 1], coords[:, 2]
            kv[:, li, bi, :, ci] = delta.to(dt)     # (n, 2, Hkv, S, D)
            ids[li, bi, ci] = coords[:, 3].to(torch.int32)
            self._hp_pending = []
        return kv, ids

    def _qa_hosttier(self, args, ext=None):
        """QA over the two-tier store in at most two rounds, each one
        retrieval forward over the store and the prefetch table.  Round 1
        is stc_tpu's speculative round: one forward with no host read
        until its end; if every selection of every layer was served, it is
        the all-device forward and its answer is exact.  Otherwise the
        pages it missed are staged and round 2 runs with `stage`: a layer
        whose selection still misses (its input changed once an earlier
        layer was served) has its pages staged before it goes on, so round
        2 serves every selection and is exact.  stc_tpu repeats the
        speculative round instead, which at 28 layers takes 5-12 rounds
        (PERF.md section 6).  The table persists across questions, so a
        repeated question takes one round.  Returns (tokens, count,
        abs_idx, exists)."""
        B, L = self.batch, self.mcfg.num_layers
        if max([len(c) for c in self._hp_cols.values()] or [0]) > \
                self._hp_cap:
            self.hp_reset()  # the table outgrew its budget: restage
        if ext is not None:
            # external indices are known up front: stage their host pages
            for b in range(B):
                need = [int(i) for i in ext[b]
                        if 0 <= i < self._evicted_pages]
                for l in range(L):
                    self._hp_fetch(l, b, need)
        ext_dev = None if ext is None else self._ids(ext)
        self.repair_layers = 0
        for r, stage in enumerate((None, self._stage_layer)):
            hp_kv, hp_ids = self._hp_device()
            tokens, count, abs_idx, exists, missing = \
                self.lm.answer_question_hosttier(
                    self.rekv, self.kvs, *args, hp_kv, hp_ids,
                    retrieved_indices=ext_dev, stage=stage,
                    **self._hist_kw())
            miss = missing.cpu().numpy()
            if not miss.any():
                self.qa_rounds = r + 1
                return tokens, count, abs_idx, exists
            self._fetch_missing(range(L), abs_idx.cpu().numpy(), miss)
        raise RuntimeError("a staged two-tier round missed a page")

    def _fetch_missing(self, layers, abs_idx, miss):
        """Queue the missing pages of abs_idx / miss ((L|1, B, topk)
        numpy) for the table, layer by layer and stream by stream."""
        for j, l in enumerate(layers):
            for b in range(self.batch):
                if miss[j, b].any():
                    self._hp_fetch(l, b, abs_idx[j, b][miss[j, b]])

    def _stage_layer(self, layer, abs_idx, missing):
        """Stage one layer's missing pages and return the table."""
        self.repair_layers += 1
        self._fetch_missing([layer], abs_idx.cpu().numpy()[None],
                            missing.cpu().numpy()[None])
        return self._hp_device()

    # ------------------------------------------------------------------ #
    def reset_streams(self, slots: Sequence[int]):
        """Recycle stream slots: each slot in `slots` returns to its
        just-after-init-prompt state (a fresh session's, for what it
        ingests next) while the other slots' streams continue untouched.
        Refused once pages were evicted: the host tier's pages are shared
        by every stream."""
        mask = np.zeros(self.batch, dtype=bool)
        mask[list(slots)] = True
        if not mask.any():
            raise ValueError("reset_streams needs at least one slot")
        if self._evicted_pages > 0:
            raise RuntimeError(
                "reset_streams with host-evicted pages is not supported: "
                "the host tier's page ring is shared across streams. "
                "clear_cache() the whole session, or size max_blocks to "
                "keep serving sessions device-resident.")
        engine.reset_streams(self.kvs, torch.as_tensor(mask),
                             self._init_len, batch_axis=1)
        self._ensure_ragged()
        self._stream_blocks[mask] = 0
        self._total_blocks = int(self._stream_blocks.max())
        # a recycled slot drafts nothing from its previous stream
        self._qa_hist[mask] = 0
        self._qa_hist_len[mask] = 0

    def kv_memory_bytes(self) -> int:
        """stc_tpu's figure for the store, kept equal so eval rows match:
        the longest stream's pages times the bytes of one page across the
        whole store's page axis, i.e. max_blocks x the bytes those pages
        hold."""
        n = int(self.kvs.num_blocks.max())
        blk = self.kvs.block_k
        per_block = int(np.prod(blk.shape[2:])) * blk.element_size() * 2
        return int(blk.shape[0] * n * per_block)
