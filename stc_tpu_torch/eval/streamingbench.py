"""StreamingBench real-time protocol harness.

Equivalent of reference streamingbench/src/benchmark/StreamingBench.py +
model/rekv.py: per question, clip the video to [0, timestamp], run a FRESH
session (clear cache -> init prompt -> encode prefix -> QA), and dump
incrementally so reruns skip answered questions.

Video clipping uses ffmpeg when a clip cache dir is configured (reference
utils/video_execution.py); a frame_loader hook allows running the protocol on
pre-decoded arrays (tests / preprocessed shards).
"""

from __future__ import annotations

import json
import os
import subprocess
from typing import Callable, List, Optional

from stc_tpu_torch.eval.solvers import load_video_frames

MCQA_TEMPLATE = (
    "{}\n{}\nKeep your response concise. "
    "Respond only with the letter of the correct option (e.g. A, B)."
)


def parse_timestamp(ts: str) -> int:
    """'hh:mm:ss' -> seconds."""
    return sum(int(x) * 60 ** i for i, x in enumerate(reversed(ts.split(":"))))


def split_video(video_path: str, start_s: int, end_s: int,
                cache_dir: str) -> str:
    """Clip [start, end] with a deterministic cache (reference
    video_execution.py:29-40): ffmpeg when present, else OpenCV re-encode
    (hosts without an ffmpeg binary — OpenCV ships its own codecs)."""
    import shutil
    os.makedirs(cache_dir, exist_ok=True)
    base = os.path.splitext(os.path.basename(video_path))[0]
    out = os.path.join(cache_dir, f"{base}_{start_s}_{end_s}.mp4")
    if not os.path.exists(out):
        if shutil.which("ffmpeg"):
            subprocess.run(
                ["ffmpeg", "-y", "-i", video_path, "-ss", str(start_s),
                 "-to", str(end_s), "-c:v", "libx264", "-an", out],
                check=True, capture_output=True)
        else:
            _split_video_cv2(video_path, start_s, end_s, out)
    return out


def _split_video_cv2(video_path: str, start_s: int, end_s: int, out: str):
    import cv2
    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        raise IOError(f"cannot open video: {video_path}")
    fps = cap.get(cv2.CAP_PROP_FPS) or 1.0
    w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    wr = cv2.VideoWriter(out, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    if not wr.isOpened():
        cap.release()
        raise IOError(f"cv2.VideoWriter cannot open: {out}")
    first, last = int(start_s * fps), int(end_s * fps)
    i = written = 0
    while True:
        ok, frame = cap.read()
        if not ok or i >= last:
            break
        if i >= first:
            wr.write(frame)
            written += 1
        i += 1
    cap.release()
    wr.release()
    # a failed/empty write must not poison split_video's exists-based cache:
    # remove the header-only file before raising
    if written == 0 or not os.path.exists(out):
        if os.path.exists(out):
            os.remove(out)
        raise IOError(
            f"clip write produced no frames: {out} "
            f"(range [{start_s},{end_s})s at {fps} fps)")


class StreamingBenchEval:
    def __init__(self, model, model_key: str, *, sample_fps: float = 1.0,
                 clip_cache_dir: str = "tmp_clips",
                 frame_loader: Optional[Callable] = None,
                 context_seconds: Optional[int] = None):
        self.model = model
        self.model_key = model_key
        self.sample_fps = sample_fps
        self.clip_cache_dir = clip_cache_dir
        self.frame_loader = frame_loader
        self.context_seconds = context_seconds  # None = from video start

    def _load_range(self, video_path: str, t_start: int, t_end: int):
        if self.frame_loader is not None:
            return self.frame_loader(video_path, t_start, t_end,
                                     self.sample_fps)
        clip = split_video(video_path, t_start, t_end, self.clip_cache_dir)
        return load_video_frames(clip, self.sample_fps)

    def _load_prefix(self, video_path: str, t_end: int):
        t_start = (0 if self.context_seconds is None
                   else max(0, t_end - self.context_seconds))
        return self._load_range(video_path, t_start, t_end)

    def run(self, data: List[dict], output_path: str) -> List[dict]:
        """data: [{questions: [{time_stamp, question, options, answer,
        task_type, ...}], video_path}] — answers written into the question
        dicts under self.model_key, dumped after every question."""
        for entry in data:
            for q in entry["questions"]:
                if q.get(self.model_key):   # rerun-resume (reference :37-38)
                    continue
                t_end = parse_timestamp(q["time_stamp"])
                frames = self._load_prefix(entry["video_path"], t_end)

                question_text = "{}\n{}".format(
                    q["question"],
                    "\n".join(q.get("options", [])))
                prompt_body = MCQA_TEMPLATE.format(
                    q["question"], "\n".join(q.get("options", [])))

                self.model.clear_cache()
                self.model.encode_init_prompt()
                self.model.encode_video(frames)
                pred = self.model.question_answering(
                    {"question": question_text,
                     "prompt": self.model.get_prompt(prompt_body, mc=True)},
                    max_new_tokens=16)
                q[self.model_key] = pred.strip()[:1] if pred else ""

                with open(output_path, "w") as f:
                    json.dump(data, f, indent=2)
        return data


# ---------------------------------------------------------------------------
# Variant drivers (reference benchmark/StreamingBenchProactive.py,
# StreamingBenchSQA.py, StreamingOpenStreamText.py).  Prompt templates are
# benchmark-defined strings kept verbatim for accuracy parity.
# ---------------------------------------------------------------------------

PROMPT_TEMPLATE_PROACTIVE = '''You are an advanced image question-answering AI assistant. You have been provided with images and a question related to the images. Your task is to carefully analyze the images and provide the answer to the question. You need to carefully confirm whether the images content meet the conditions of the question, and then output the correct content.

Question: {}

The answer is:
'''

PROMPT_TEMPLATE_SQA = '''You are an advanced video question-answering AI assistant. You have been provided with a video and a multiple-choice question related to the video. Your task is to carefully analyze the video and the provided context to answer the question, choosing from the four options provided. Respond with only the letter (A, B, C, or D) of the correct option.

{}

Here is the question. Answer it and don't confuse it with the previous conversation.
Question: {}

Options:
{}
{}
{}
{}

The best option is:'''

PROMPT_TEMPLATE_OPEN = '''You are an advanced video question-answering AI assistant. You have been provided with some frames from the video and a multiple-choice question related to the video. Your task is to carefully analyze the video and provide the best answer to question, choosing from the four options provided. Respond with only the letter (A, B, C, or D) of the correct option.

Question: {}

Options:
{}
{}
{}
{}'''

PROMPT_TEMPLATE_OPEN_NO_OPTIONS = '''You are an advanced video question-answering AI assistant. You have been provided with a video and a question related to the video. Your task is to carefully analyze the video and provide the answer to the question. 

Question: {}
'''


def _letterize(options):
    if options and not options[0].startswith("A."):
        return [f"{c}. {o}" for c, o in zip("ABCD", options)]
    return list(options)


class StreamingBenchProactiveEval(StreamingBenchEval):
    """Proactive protocol (StreamingBenchProactive.py): from the question
    timestamp, poll once per second asking whether it is the right time to
    emit the ground-truth output; on the first 'yes' (up to ground truth
    + 4 s), ask the real question.  Records the full dialog history and the
    answer time."""

    def run(self, data: List[dict], output_path: str) -> List[dict]:
        import time as _time
        for entry in data:
            for q in entry["questions"]:
                prev = q.get(self.model_key)
                if prev and prev["dialog_history"] and \
                        prev["dialog_history"][-1]["content"]:
                    continue  # rerun-resume (reference :30-31)
                start = parse_timestamp(q["time_stamp"])
                gt_time = parse_timestamp(q["ground_truth_time_stamp"])
                max_time = gt_time + 4
                query = (f"{q['question']} Is it the right time to output "
                         f"\"{q['ground_truth_output']}\"? You can only "
                         "answer yes or no.")
                inp = PROMPT_TEMPLATE_PROACTIVE.format(query)
                dialog, answered = [], False
                cur = start + 1
                while cur <= max_time:
                    frames = self._load_range(entry["video_path"], start, cur)
                    self.model.clear_cache()
                    self.model.encode_init_prompt()
                    self.model.encode_video(frames)
                    t0 = _time.time()
                    resp = self.model.question_answering(
                        {"question": inp,
                         "prompt": self.model.get_prompt(inp, mc=False)},
                        max_new_tokens=16)
                    cost = _time.time() - t0
                    dialog.append({"role": "user", "content": query,
                                   "time": cur, "cost": cost})
                    dialog.append({"role": "assistant", "content": resp,
                                   "time": cur, "cost": cost})
                    if "yes" in resp.strip().lower():
                        inp2 = PROMPT_TEMPLATE_PROACTIVE.format(q["question"])
                        t0 = _time.time()
                        resp = self.model.question_answering(
                            {"question": inp2,
                             "prompt": self.model.get_prompt(inp2, mc=False)},
                            max_new_tokens=32)
                        cost = _time.time() - t0
                        dialog.append({"role": "user",
                                       "content": q["question"],
                                       "time": cur, "cost": cost})
                        dialog.append({"role": "assistant", "content": resp,
                                       "time": cur, "cost": cost})
                        answered = cur
                        break
                    cur += 1
                q[self.model_key] = {"answered": answered,
                                     "dialog_history": dialog}
                with open(output_path, "w") as f:
                    json.dump(data, f, indent=2)
        return data


class StreamingBenchSQAEval(StreamingBenchEval):
    """Sequential-QA protocol (StreamingBenchSQA.py): per video, a running
    textual context of all previous (question, options, answer) triples is
    prepended to every new question."""

    def run(self, data: List[List[dict]], output_path: str):
        """data: [video_data], video_data: [subset{video_path, questions}]."""
        for video_data in data:
            context = ""
            for subset in video_data:
                for q in subset["questions"]:
                    if q.get(self.model_key):
                        continue
                    t_end = parse_timestamp(q["time_stamp"])
                    frames = self._load_prefix(subset["video_path"], t_end)
                    options = _letterize(q["options"])
                    inp = PROMPT_TEMPLATE_SQA.format(
                        context, q["question"], *options)
                    self.model.clear_cache()
                    self.model.encode_init_prompt()
                    self.model.encode_video(frames)
                    pred = self.model.question_answering(
                        {"question": inp,
                         "prompt": self.model.get_prompt(inp, mc=True)},
                        max_new_tokens=16)
                    q[self.model_key] = (pred or "").strip()
                    if not context:
                        context += ("Here are the contextual information "
                                    "related to the video. Please answer the "
                                    "questions based on the contextual "
                                    "information: ")
                    context += (
                        f"At timestamp {q['time_stamp']}, the following "
                        f"question and answer occurred: Question: "
                        f"{q['question']}; Options: {options[0]}, "
                        f"{options[1]}, {options[2]}, {options[3]}; "
                        f"Answer: {q['answer']}; ")
                    with open(output_path, "w") as f:
                        json.dump(data, f, indent=2)
        return data


class StreamingOpenStreamTextEval(StreamingBenchEval):
    """Open-stream protocol (StreamingOpenStreamText.py): ONE continuous
    session per subset — each question only encodes the video segment since
    the previous question (this is where the streaming KV engine shines; the
    reference re-feeds clips to stateful models the same way)."""

    def run(self, data: List[dict], output_path: str) -> List[dict]:
        for subset in data:
            begin = True
            prev_time = 0
            for q in subset["questions"]:
                if q.get(self.model_key):
                    continue
                t_end = parse_timestamp(q["time_stamp"])
                frames = self._load_range(subset["video_path"],
                                          max(0, prev_time), t_end)
                prev_time = t_end
                if "options" in q:
                    options = _letterize(q["options"])
                    inp = PROMPT_TEMPLATE_OPEN.format(q["question"], *options)
                    inp += "\n\nThe best option is:"
                    mc = True
                else:
                    inp = PROMPT_TEMPLATE_OPEN_NO_OPTIONS.format(q["question"])
                    inp += "\n\nAnswer:"
                    mc = False
                if begin:
                    self.model.clear_cache()
                    self.model.encode_init_prompt()
                    begin = False
                self.model.encode_video(frames)
                pred = self.model.question_answering(
                    {"question": inp,
                     "prompt": self.model.get_prompt(inp, mc=mc)},
                    max_new_tokens=16 if mc else 64)
                q[self.model_key] = (pred or "").strip()
                with open(output_path, "w") as f:
                    json.dump(data, f, indent=2)
        return data
