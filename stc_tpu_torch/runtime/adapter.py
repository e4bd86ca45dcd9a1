"""Text-level model adapter: tokenizer + StreamingSession -> the 4-method
string API the eval harnesses consume.

Mirrors the reference model surface used by the solvers
(llava_onevision_rekv.py get_prompt/question_answering + Abstract_ReKV):
the reference models tokenize internally; here tokenization is a thin
adapter so the session stays tensor-only and testable without HF.
"""

from __future__ import annotations

from typing import Optional, Sequence


class ChatTemplate:
    """llava-onevision chat format (reference llava_onevision_rekv.py:32-36,
    164)."""

    init_prompt = ("<|im_start|>system \nYou are a helpful assistant."
                   "<|im_end|><|im_start|>user ")

    @staticmethod
    def wrap(query: str, mc: bool = False) -> str:
        prompt = f"\n{query}<|im_end|><|im_start|>assistant\n"
        if mc:
            prompt += "Best option: ("
        return prompt


class SessionAdapter:
    """Wraps a StreamingSession with a tokenizer for the string-level API."""

    def __init__(self, session, tokenizer, template=ChatTemplate,
                 stop_token_ids: Optional[Sequence[int]] = None):
        self.session = session
        self.tokenizer = tokenizer
        self.template = template
        if stop_token_ids is None:
            eos = getattr(tokenizer, "eos_token_id", None)
            stop_token_ids = [eos] if eos is not None else [0]
        self.stop_token_ids = list(stop_token_ids)
        self._init_ids = self._encode(template.init_prompt)

    def _encode(self, text: str):
        ids = self.tokenizer(text)
        if hasattr(ids, "input_ids"):
            ids = ids.input_ids
        if ids and isinstance(ids[0], list):
            ids = ids[0]
        return list(ids)

    @property
    def init_prompt_len(self) -> int:
        """Use this as ReKVConfig.n_init when building the session."""
        return len(self._init_ids)

    def get_prompt(self, query: str, mc: bool = False) -> str:
        return self.template.wrap(query, mc)

    # --- reference Abstract_ReKV surface ---
    def clear_cache(self):
        self.session.clear_cache()

    def encode_init_prompt(self):
        self.session.encode_init_prompt(self._init_ids)

    def encode_video(self, frames, active=None):
        if active is None:
            self.session.encode_video(frames)
        else:
            self.session.encode_video(frames, active=active)

    def question_answering(self, input_text, max_new_tokens: int = 128) -> str:
        if isinstance(input_text, str):
            question, prompt = input_text, input_text
        else:
            question = input_text["question"]
            prompt = input_text["prompt"]
        out_ids = self.session.question_answering(
            self._encode(question), self._encode(prompt),
            stop_token_ids=self.stop_token_ids,
            max_new_tokens=max_new_tokens)
        return self.tokenizer.decode(out_ids, skip_special_tokens=True)

    def question_answering_batch(self, inputs,
                                 max_new_tokens: int = 128):
        """Per-stream questions in one batched QA: `inputs[b]` is a
        str / {"question","prompt"} dict, or None for an idle slot (its
        row rides as a masked dummy).  Returns one decoded string per
        stream (None for idle slots)."""
        B = self.session.batch
        assert len(inputs) == B, (len(inputs), B)
        qs, ps, asked = [], [], []
        for it in inputs:
            if it is None:
                qs.append([0])
                ps.append([0])
                asked.append(False)
                continue
            q = it if isinstance(it, str) else it["question"]
            p = it if isinstance(it, str) else it["prompt"]
            qs.append(self._encode(q))
            ps.append(self._encode(p))
            asked.append(True)
        outs = self.session.question_answering_batch(
            qs, ps, self.stop_token_ids, max_new_tokens=max_new_tokens,
            asked=asked)
        return [self.tokenizer.decode(o, skip_special_tokens=True)
                if a else None for o, a in zip(outs, asked)]

    def calc_memory_usage(self) -> int:
        return self.session.kv_memory_bytes()
