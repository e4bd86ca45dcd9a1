"""Continuous-batching serving engine over one batched streaming session
(port of ``stc_tpu/runtime/serving.py``).

Multiplexes B independent streams (each its own video and questions,
arriving at its own rate) onto the B slots of one StreamingSession or
VLMSession.  Each scheduler tick drains at most one frame chunk and one
question per slot and batches them:

  - encode work rides a ragged call (per-stream ``active`` masks; the
    inactive streams' state stays bit-identical),
  - question work rides one batched QA of per-stream questions
    (session.question_answering_batch), and
  - a tick with both runs the session's serving tick (session.serve:
    the encode, then the questions), whose answers see that tick's chunk.

A finished stream's slot is recycled for the next one (retire / admit).
"""

from __future__ import annotations

import collections
from dataclasses import dataclass, field
from typing import Any, Dict, List, Sequence

import numpy as np


@dataclass
class _Request:
    question_ids: List[int]
    prompt_ids: List[int]
    request_id: int


@dataclass
class ServingStats:
    ticks: int = 0
    fused_ticks: int = 0       # ticks that took the session's serve path
    encode_chunks: int = 0
    answers: int = 0
    streams_retired: int = 0
    streams_admitted: int = 0
    # per-slot counters
    slot_chunks: List[int] = field(default_factory=list)
    slot_answers: List[int] = field(default_factory=list)


class ServingEngine:
    """Continuous-batching multiplexer.

    session: a StreamingSession (features in) or VLMSession (pixels in)
    with batch == the number of slots.  stop_token_ids / max_new_tokens are
    engine-wide: one tick's batched QA shares the stop set and the decode
    budget across streams.
    """

    def __init__(self, session, stop_token_ids: Sequence[int],
                 max_new_tokens: int = 32):
        self.sess = session
        self.n_slots = session.batch
        self.stop_token_ids = list(stop_token_ids)
        self.max_new_tokens = max_new_tokens
        self._chunks = [collections.deque() for _ in range(self.n_slots)]
        self._questions = [collections.deque() for _ in range(self.n_slots)]
        self._next_rid = 0
        self._free: set = set()  # retired slots awaiting admission
        self.stats = ServingStats(slot_chunks=[0] * self.n_slots,
                                  slot_answers=[0] * self.n_slots)

    # ------------------------------------------------------------------ #
    def _serving(self, slot: int) -> None:
        if slot in self._free:
            raise ValueError(f"slot {slot} is retired (admit first)")

    def submit_chunk(self, slot: int, chunk) -> None:
        """Queue one frame chunk for `slot`.

        Features session: (T, E) pruned features, T a block_size multiple.
        VLM session: (n_frames, H, W, 3) uint8 pixels.
        Every queued chunk must share one shape: ticks batch across slots.
        """
        self._serving(slot)
        chunk = np.asarray(chunk)
        for q in self._chunks:
            if q:
                if q[0].shape != chunk.shape:
                    raise ValueError(
                        "serving ticks batch one chunk per slot into one "
                        "call; all queued chunks must share a shape, got "
                        f"{chunk.shape} vs {q[0].shape}")
                break
        self._chunks[slot].append(chunk)

    def submit_question(self, slot: int, question_ids: Sequence[int],
                        prompt_ids: Sequence[int]) -> int:
        """Queue a question for `slot`; returns a request id that keys the
        answer in step()'s result dict."""
        self._serving(slot)
        rid = self._next_rid
        self._next_rid += 1
        self._questions[slot].append(
            _Request(list(question_ids), list(prompt_ids), rid))
        return rid

    # ------------------------------------------------------------------ #
    def retire(self, slot: int) -> None:
        """A stream ended: drop its queued work, recycle its session slot
        (session.reset_streams: counters, rep keys, cacher references,
        pruner memory and draft history back to a fresh session's) and mark
        the slot free for the next stream.  The other slots' streams
        continue untouched."""
        if not 0 <= slot < self.n_slots:
            raise ValueError(f"no slot {slot} of {self.n_slots}")
        self._serving(slot)
        self._chunks[slot].clear()
        self._questions[slot].clear()
        self.sess.reset_streams([slot])
        self._free.add(slot)
        self.stats.streams_retired += 1

    def admit(self) -> int:
        """Claim a recycled slot for a new stream; returns the slot id.
        Raises if no slot is free (the slot count is the session's batch)."""
        if not self._free:
            raise RuntimeError(
                f"all {self.n_slots} slots are serving; retire one first")
        slot = min(self._free)
        self._free.discard(slot)
        self.stats.streams_admitted += 1
        return slot

    @property
    def free_slots(self) -> int:
        return len(self._free)

    def is_free(self, slot: int) -> bool:
        """True if `slot` is retired and awaiting admission."""
        return slot in self._free

    @property
    def pending(self) -> int:
        return (sum(len(q) for q in self._chunks)
                + sum(len(q) for q in self._questions))

    @property
    def route_decisions(self) -> Dict:
        """stc_tpu's settled choices between one merged serve program and
        two; the port has no such router (its serve path is taken wherever
        it is eligible), so always {}."""
        return {}

    # ------------------------------------------------------------------ #
    def step(self) -> Dict[int, Dict[str, Any]]:
        """One scheduler tick: drain <= 1 chunk and <= 1 question per slot.

        Returns {request_id: {"slot": b, "tokens": [...]}} for every question
        answered this tick (empty on an encode-only or idle tick).
        """
        enc = [q.popleft() if q else None for q in self._chunks]
        ask = [q.popleft() if q else None for q in self._questions]
        any_enc = any(c is not None for c in enc)
        any_ask = any(r is not None for r in ask)
        if not (any_enc or any_ask):
            return {}
        self.stats.ticks += 1

        active = np.asarray([c is not None for c in enc])
        for b, c in enumerate(enc):
            if c is not None:
                self.stats.slot_chunks[b] += 1
                self.stats.encode_chunks += 1
        feats = None
        if any_enc:
            shape = next(c for c in enc if c is not None).shape
            feats = np.stack([c if c is not None
                              else np.zeros(shape, enc_dtype(enc))
                              for c in enc])

        out: Dict[int, Dict[str, Any]] = {}
        if not any_ask:
            self._encode(feats, active)
            return out

        # placeholder rows for slots not asking (their answers are dropped)
        questions = [(r.question_ids if r else [0]) for r in ask]
        prompts = [(r.prompt_ids if r else [0]) for r in ask]
        asked = [r is not None for r in ask]
        if any_enc:
            tokens, count = self.sess.serve(
                feats, active, questions, prompts, self.stop_token_ids,
                max_new_tokens=self.max_new_tokens, asked=asked)
            if self.sess.last_serve_fused:
                self.stats.fused_ticks += 1
            answers = [[int(t) for t in tokens[b, :int(count[b])]]
                       for b in range(self.n_slots)]
        else:
            answers = self.sess.question_answering_batch(
                questions, prompts, self.stop_token_ids,
                max_new_tokens=self.max_new_tokens, asked=asked)
        for b, r in enumerate(ask):
            if r is not None:
                self.stats.slot_answers[b] += 1
                self.stats.answers += 1
                out[r.request_id] = {"slot": b, "tokens": answers[b]}
        return out

    def run(self, max_ticks: int = 1_000_000) -> Dict[int, Dict[str, Any]]:
        """Drain all queued work; returns the merged answer dict."""
        out: Dict[int, Dict[str, Any]] = {}
        for _ in range(max_ticks):
            if self.pending == 0:
                return out
            out.update(self.step())
        raise RuntimeError("serving queue did not drain")

    # ------------------------------------------------------------------ #
    def _encode(self, feats: np.ndarray, active: np.ndarray) -> None:
        if hasattr(self.sess, "vision"):   # a VLM session takes pixels
            self.sess.encode_video(feats, active=active)
        else:
            self.sess.encode_video_features(feats, active=active)


def enc_dtype(enc) -> np.dtype:
    return next(c for c in enc if c is not None).dtype
