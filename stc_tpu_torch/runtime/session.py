"""Streaming session runtime (port of ``stc_tpu/runtime/session.py``,
main-path subset): the plug-and-play API

    clear_cache() / encode_init_prompt(ids) / encode_video_features(feats)
    / question_answering(...)

over one device-resident page store.  With ``weights_quant`` set, the
session quantizes the LM it is given to int8 at build (in place).  Left
out until their ROADMAP.md items land: the host tier (a stream past
max_blocks raises), meshes, the serve router, speculative decode and
external retrieval.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from stc_tpu_torch.config import SessionConfig
from stc_tpu_torch.models.qwen2 import Qwen2


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
                 state_dtype=torch.bfloat16):
        session_cfg.check_main_path()
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
        if rc.retrieve_len > rc.n_init + rc.n_local:
            raise ValueError(
                f"retrieve_len={rc.retrieve_len} exceeds n_init + n_local = "
                f"{rc.n_init + rc.n_local}: retrieved blocks beyond the "
                "local window can never be attended. Lower topk or raise "
                "n_local.")
        # per-layer block indices chosen by the last QA, stream 0
        self.last_retrieved_indices = None
        self.kvs = None
        self.clear_cache()

    def clear_cache(self):
        self.kvs = self.lm.init_stream_state(self.rekv, self.batch,
                                             self.state_dtype)
        self._total_blocks = 0

    # ------------------------------------------------------------------ #
    def _check_rep_capacity(self, incoming_blocks: int):
        """The rep keys score the FULL block history; past rep_cap new
        blocks would overwrite the last rep slot.  Fail fast."""
        rc = self.rekv
        if self._total_blocks + incoming_blocks > rc.rep_cap:
            raise RuntimeError(
                f"stream exceeds rep-key capacity: {self._total_blocks} + "
                f"{incoming_blocks} blocks > rep_cap={rc.rep_cap}. Set "
                "ReKVConfig.max_rep_blocks to at least the number of frames "
                "in the stream.")

    def _maybe_evict(self, incoming_blocks: int):
        """Where the JAX session offloads the oldest pages to its host tier,
        the port stops: the host tier is not ported yet."""
        self._check_rep_capacity(incoming_blocks)
        if self._total_blocks + incoming_blocks > self.rekv.max_blocks:
            raise RuntimeError(
                f"stream of {self._total_blocks + incoming_blocks} blocks "
                f"outgrows the device page store (max_blocks="
                f"{self.rekv.max_blocks}) and the port has no host tier to "
                "evict to yet (ROADMAP.md queue 1, 'Host tier'). Raise "
                "max_blocks.")

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

    def encode_video_features(self, feats):
        """feats: (B, n_frames * block_size, E) pruned visual features;
        one attention call per exc_block_size tokens."""
        feats = torch.as_tensor(feats, device=self.device).to(self.lm.dtype)
        B, T, E = feats.shape
        S, exc = self.rekv.block_size, self.rekv.exc_block_size
        if T % S:
            raise ValueError((T, S))
        self._check_rep_capacity(T // S)
        for i in range(0, T, exc):
            n = min(exc, T - i) // S
            self._maybe_evict(n)
            self.lm.encode_step(self.rekv, self.kvs, feats[:, i:i + n * S],
                                is_init=False)
            self._total_blocks += n

    # ------------------------------------------------------------------ #
    def question_answering(self, question_ids: Sequence[int],
                           prompt_ids: Sequence[int],
                           stop_token_ids: Sequence[int],
                           max_new_tokens: int = 128) -> List[int]:
        """Retrieve with question_ids, then greedy-decode from prompt_ids;
        returns stream 0's answer ids."""
        B = self.batch
        q_ids, q_len = self._pad_ids([question_ids] * B)
        p_ids, p_len = self._pad_ids([prompt_ids] * B)
        tokens, count = self._qa_run(q_ids, q_len, p_ids, p_len,
                                     stop_token_ids, max_new_tokens)
        return [int(t) for t in tokens[0, :int(count[0])]]

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
                max_new_tokens: int):
        """Retrieval + prefill + greedy decode.  Returns (tokens (B, M),
        count (B,)) as numpy."""
        tokens, count, abs_idx, exists = self.lm.answer_question(
            self.rekv, self.kvs, self._ids(q_ids), self._ids(q_len),
            self._ids(p_ids), self._ids(p_len),
            self._ids(_stop_arr(stop_token_ids)), max_new_tokens)
        a, e = abs_idx[:, 0].cpu().numpy(), exists[:, 0].cpu().numpy()
        self.last_retrieved_indices = [[int(i) for i in a[l][e[l]]]
                                       for l in range(a.shape[0])]
        return tokens.cpu().numpy(), count.cpu().numpy()
