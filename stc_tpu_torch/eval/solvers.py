"""VQA solvers — offline, VideoMME-instrumented, and streaming.

Equivalents of reference model/video_qa/{base,rekv_offline,videomme,
rekv_stream}_refactored.py.  Solvers consume the string-level model adapter
(runtime/adapter.py) and annotation dicts; video IO is pluggable (decord when
available, else a caller-provided frame loader), so the solver logic is
testable without video files.  decord and OpenCV are imported only when a
video file is decoded: importing this module needs neither.  Encode times
(``encode_time_s``) are taken with a utils/metrics.Timer synchronised to
the session's device when it is a CUDA card.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np

from stc_tpu_torch.eval.scorers import extract_choice
from stc_tpu_torch.utils.metrics import Timer, device_sync

CHOICE_LETTERS = ["A", "B", "C", "D", "E", "F", "G", "H"]


def load_video_frames(video_path: str, sample_fps: float = 1.0) -> np.ndarray:
    """Decode frames at sample_fps (reference base_refactored.py:27-33).

    decord when installed (the reference's decoder), else OpenCV — same
    sampling rule (every round(fps)/sample_fps-th frame) either way."""
    if video_path.endswith(".npy"):
        video = np.load(video_path)
        if sample_fps < 1:
            idx = np.linspace(0, len(video) - 1, int(len(video) * sample_fps),
                              dtype=int)
            video = video[idx]
        return video
    try:
        from decord import VideoReader, cpu  # optional C++ decoder
    except ImportError:
        return _load_video_frames_cv2(video_path, sample_fps)
    vr = VideoReader(video_path, ctx=cpu(0))
    fps = round(vr.get_avg_fps())
    idx = list(range(0, len(vr), max(1, int(fps / sample_fps))))
    return vr.get_batch(idx).asnumpy()


def _load_video_frames_cv2(video_path: str, sample_fps: float) -> np.ndarray:
    """OpenCV decode path (BGR -> RGB), mirroring the decord sampling."""
    import cv2
    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        raise IOError(f"cannot open video: {video_path}")
    fps = round(cap.get(cv2.CAP_PROP_FPS) or 1)
    step = max(1, int(fps / sample_fps))
    frames, i = [], 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        if i % step == 0:
            frames.append(frame[:, :, ::-1])
        i += 1
    cap.release()
    if not frames:
        raise IOError(f"no frames decoded from {video_path}")
    return np.ascontiguousarray(np.stack(frames))


class BaseVQA:
    # decode budgets (reference base_refactored.py: 16 MC / 1024 open)
    mc_max_new = 16
    open_max_new = 1024

    def __init__(self, model, sample_fps: float = 0.5,
                 frame_loader: Optional[Callable] = None):
        self.model = model
        self.sample_fps = sample_fps
        self.frame_loader = frame_loader or load_video_frames
        self.results: List[dict] = []

    def _timer(self) -> Timer:
        """A Timer that waits for the model's session device (a CUDA
        card) at both ends; a plain host clock otherwise."""
        session = getattr(self.model, "session", None)
        return Timer(device_sync(getattr(session, "device", None)))

    def __call__(self, sample: dict) -> List[dict]:
        frames = self.frame_loader(sample["video_path"], self.sample_fps)
        self.encode_video(frames)
        return self.answer_questions(sample)

    def encode_video(self, frames):
        self.model.clear_cache()
        self.model.encode_init_prompt()
        self.model.encode_video(frames)

    def answer_questions(self, sample: dict) -> List[dict]:
        out = []
        for qa in sample["conversations"]:
            r = self.answer_single(qa, sample["video_id"])
            out.append(r)
            self.results.append(r)
        return out

    def answer_single(self, qa: dict, video_id) -> dict:
        if "choices" in qa:
            return self._mc_qa(qa, video_id)
        return self._open_qa(qa, video_id)

    # -- prompts (reference base_refactored.py:66-80) --
    def format_mcqa_prompt(self, question: str, choices: List[str]) -> str:
        opts = "\n".join(f"({CHOICE_LETTERS[i]}) {c}"
                         for i, c in enumerate(choices))
        q = (f"Question: {question}\nOptions:\n{opts}\n"
             "Only give the best option.")
        return self.model.get_prompt(q, mc=True)

    def format_openqa_prompt(self, question: str) -> str:
        return self.model.get_prompt(question)

    # -- answering --
    def _open_qa(self, qa, video_id):
        pred = self.model.question_answering(
            {"question": qa["question"],
             "prompt": self.format_openqa_prompt(qa["question"])},
            max_new_tokens=self.open_max_new)
        return self._open_row(qa, video_id, pred)

    def _mc_qa(self, qa, video_id):
        pred = self.model.question_answering(
            {"question": qa["question"],
             "prompt": self.format_mcqa_prompt(qa["question"],
                                               qa["choices"])},
            max_new_tokens=self.mc_max_new)
        return self._mc_row(qa, video_id, pred)

    # -- result rows (shared with the batched solver) --
    def _open_row(self, qa, video_id, pred: str) -> dict:
        return {"video_id": video_id, "question": qa["question"],
                "answer": qa.get("answer"),
                "pred_answer": pred.replace("\n", "")}

    def _mc_row(self, qa, video_id, pred: str) -> dict:
        pred_choice = extract_choice(pred)
        correct = self._correct_choice(qa)
        return {"video_id": video_id, "question": qa["question"],
                "choices": qa["choices"], "answer": qa.get("answer"),
                "correct_choice": correct,
                "pred_answer": pred.replace("\n", ""),
                "pred_choice": pred_choice,
                "qa_acc": float(pred_choice == correct) * 100}

    def _correct_choice(self, qa) -> str:
        answer = qa.get("answer")
        if answer is None:
            return CHOICE_LETTERS[0]
        try:
            return CHOICE_LETTERS[qa["choices"].index(answer)]
        except ValueError:
            return CHOICE_LETTERS[0]


class OfflineVQA(BaseVQA):
    """Whole video encoded once, then all questions (rekv_offline)."""


class VideoMMEVQA(BaseVQA):
    """Offline solver with per-video encode timing + KV memory stats
    (reference videomme_refactored.py:20-44)."""

    def __call__(self, sample):
        frames = self.frame_loader(sample["video_path"], self.sample_fps)
        with self._timer() as t:
            self.encode_video(frames)
        encode_s = t.seconds
        rows = self.answer_questions(sample)
        for r in rows:
            r["encode_time_s"] = round(encode_s, 3)
            r["kv_memory_gb"] = round(
                self.model.calc_memory_usage() / 1024 ** 3, 3)
        return rows


class StreamVQA(BaseVQA):
    """Incremental encoding by QA temporal windows (rekv_stream_refactored):
    frames are fed up to each question's end_time before answering — one
    session per video, stream continues across questions."""

    def __call__(self, sample):
        frames = self.frame_loader(sample["video_path"], self.sample_fps)
        self.model.clear_cache()
        self.model.encode_init_prompt()

        fed = 0
        out = []
        for qa in sample["conversations"]:
            end_t = qa.get("end_time", None)
            end_idx = (len(frames) if end_t is None
                       else min(len(frames), int(end_t * self.sample_fps)))
            if end_idx > fed:
                self.model.encode_video(frames[fed:end_idx])
                fed = end_idx
            r = self._open_qa(qa, sample["video_id"])
            out.append(r)
            self.results.append(r)
        return out


class BatchedOfflineVQA(BaseVQA):
    """Concurrent offline eval: B videos share ONE batched session.

    Videos of different lengths ingest via ragged multi-stream ticks (per-
    chunk active masks; tail chunks grouped by size), and each question
    round answers per-stream questions in one batched dispatch — so a
    single chip evaluates B samples at a time, with every row EXACTLY equal
    to the sequential solver's (per-stream parity is bit-exact; QA rounds
    are grouped by question type so each keeps its own decode budget).
    The reference gets eval parallelism only by replicating the model one
    process per worker (run_distributed.py / eval.py mp.spawn).

    instrumented=True (videomme protocol) stamps rows with encode timing +
    KV memory like VideoMMEVQA — encode_time_s is the BATCH ingest time
    (shared by the B concurrent videos), not a per-video figure.
    """

    instrumented = False

    def run_batch(self, samples: List[dict]) -> List[dict]:
        model = self.model
        sess = model.session
        B = sess.batch
        assert 0 < len(samples) <= B, (len(samples), B)
        # per-sample loader isolation: one unreadable video becomes one
        # error row, not a whole-group loss (its slot just stays inactive)
        frames: List[Optional[np.ndarray]] = []
        load_err: List[Optional[str]] = []
        for s in samples:
            try:
                frames.append(self.frame_loader(s["video_path"],
                                                self.sample_fps))
                load_err.append(None)
            except Exception as e:
                frames.append(None)
                load_err.append(str(e))
        lens = [len(f) if f is not None else 0 for f in frames]
        lens += [0] * (B - len(samples))
        n = getattr(sess.scfg, "encode_chunk_frames", 1)

        # host-tier spill needs UNIFORM streams (eviction shifts every ring
        # together); fail fast with the knobs instead of mid-ingest
        cap = sess.rekv.max_blocks
        if max(lens) > cap and len({l for l in lens if l}) > 1:
            raise RuntimeError(
                f"batched eval group exceeds device KV capacity "
                f"(longest video {max(lens)} blocks > max_blocks={cap}) "
                "with UNEQUAL lengths — host-tier eviction shifts all "
                "streams' rings together.  Raise ReKVConfig.max_blocks, "
                "lower --stream_batch, or group equal-length videos.")

        with self._timer() as timer:
            model.clear_cache()
            model.encode_init_prompt()

            # videos keep their NATIVE resolution until the on-device
            # resize (exactly like the sequential path), so ticks are
            # grouped by resolution: streams sharing (H, W) batch into one
            # dispatch
            res_groups: Dict[tuple, List[int]] = {}
            for b, f in enumerate(frames):
                if f is not None and len(f):
                    res_groups.setdefault(f.shape[1:], []).append(b)
            for res, slots in res_groups.items():
                zero = np.zeros((1,) + res, dtype=frames[slots[0]].dtype)

                def rows_for(size, start_of, act):
                    return np.stack([
                        frames[b][start_of(b):start_of(b) + size] if act[b]
                        else np.broadcast_to(zero, (size,) + res)
                        for b in range(B)])

                # full chunks, ragged over this resolution group's lengths
                for start in range(0, max(lens[b] for b in slots), n):
                    act = [b in slots and lens[b] - start >= n
                           for b in range(B)]
                    if any(act):
                        model.encode_video(
                            rows_for(n, lambda b: start, act), active=act)
                # tail chunks, grouped by remainder size (each stream's own
                # frame order is preserved — its tail follows its full
                # chunks)
                tails: Dict[int, List[int]] = {}
                for b in slots:
                    if lens[b] % n:
                        tails.setdefault(lens[b] % n, []).append(b)
                for r, bs in sorted(tails.items()):
                    act = [b in bs for b in range(B)]
                    model.encode_video(
                        rows_for(r, lambda b: lens[b] - r, act), active=act)
        encode_s = timer.seconds

        # question rounds: per-stream questions batched, grouped by type so
        # MC (16-token budget) and open (1024) stay exact vs sequential
        per_sample: List[List[dict]] = [
            [{"video_id": s.get("video_id"), "error": e}] if e else []
            for s, e in zip(samples, load_err)]
        max_q = max(len(s["conversations"]) for s in samples)
        for qi in range(max_q):
            round_qas = [(b, samples[b]["conversations"][qi])
                         for b in range(len(samples))
                         if load_err[b] is None
                         and qi < len(samples[b]["conversations"])]
            for mc, budget in ((True, self.mc_max_new),
                               (False, self.open_max_new)):
                group = [(b, qa) for b, qa in round_qas
                         if ("choices" in qa) == mc]
                if not group:
                    continue
                inputs = [None] * B
                for b, qa in group:
                    prompt = (self.format_mcqa_prompt(qa["question"],
                                                      qa["choices"])
                              if mc else
                              self.format_openqa_prompt(qa["question"]))
                    inputs[b] = {"question": qa["question"],
                                 "prompt": prompt}
                preds = model.question_answering_batch(
                    inputs, max_new_tokens=budget)
                for b, qa in group:
                    row = (self._mc_row(qa, samples[b]["video_id"],
                                        preds[b]) if mc else
                           self._open_row(qa, samples[b]["video_id"],
                                          preds[b]))
                    per_sample[b].append(row)
        out = [r for rows in per_sample for r in rows]
        if self.instrumented:
            # videomme protocol stats, per BATCH: encode_time_s covers the
            # whole group's ingest and kv_memory_gb is the SHARED B-stream
            # store (≈ stream_batch x the sequential per-video figure)
            kv_gb = round(model.calc_memory_usage() / 1024 ** 3, 3)
            for r in out:
                if "error" not in r:
                    r["encode_time_s"] = round(encode_s, 3)
                    r["kv_memory_gb"] = kv_gb
        self.results.extend(out)
        return out


SOLVERS: Dict[str, type] = {
    "offline": OfflineVQA,
    "videomme": VideoMMEVQA,
    "stream": StreamVQA,
}


def create_solver(name: str, model, sample_fps: float = 0.5,
                  frame_loader=None) -> BaseVQA:
    cls = SOLVERS.get(name, OfflineVQA)  # reference factory falls back too
    return cls(model, sample_fps, frame_loader)
