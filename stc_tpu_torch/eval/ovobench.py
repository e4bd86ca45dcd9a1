"""OVO-Bench protocol harness.

Equivalent of reference ovobench/inference_distributed.py + utils/OVOBench.py:
task groups (backward EPM/ASI/HLD, realtime STU/OJR/ATR/ACR/OCR/FPD, forward
REC/SSR/CRR), per-task prompt templates (reference constant.py — benchmark-
defined strings kept verbatim for accuracy parity), per-sample try/except
with error rows, and contiguous data splitting across processes.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Optional

from stc_tpu_torch.eval.solvers import load_video_frames

BACKWARD_TASKS = ["EPM", "ASI", "HLD"]
REALTIME_TASKS = ["OCR", "ACR", "ATR", "STU", "FPD", "OJR"]
FORWARD_TASKS = ["REC", "SSR", "CRR"]

BR_PROMPT_TEMPLATE = """
Question: {}
Options:
{}

Respond only with the letter corresponding to your chosen option (e.g., A, B, C).
Do not include any additional text or explanation in your response.
"""

REC_PROMPT_TEMPLATE = """
You're watching a video in which people may perform a certain type of action repetively.
The person performing this kind of action are referred to as 'they' in the following statement.
You're task is to count how many times have different people in the video perform this kind of action in total.
One complete motion counts as one.
Now, answer the following question: {}
Provide your answer as a single number (e.g., 0, 1, 2, 3…) indicating the total count.
Do not include any additional text or explanation in your response.
"""

SSR_PROMPT_TEMPLATE = """
You're watching a tutorial video which contain a sequential of steps.
The following is one step from the whole procedures:
{}
Your task is to determine if the man or woman in the video is currently performing this step.
Answer only with “Yes” or “No”.
Do not include any additional text or explanation in your response.
"""

CRR_PROMPT_TEMPLATE = """
You're responsible of answering questions based on the video content.
The following question are relevant to the latest frames, i.e. the end of the video.
{}
Decide whether existing visual content, especially latest frames, i.e. frames that near the end of the video, provide enough information for answering the question.
Answer only with “Yes” or “No”.
Do not include any additional text or explanation in your response.
"""


def build_prompt(task: str, question=None, options=None, anno=None,
                 index=None) -> str:
    """Reference OVOBench.build_prompt (utils/OVOBench.py:126-141)."""
    if task in BACKWARD_TASKS + REALTIME_TASKS:
        opts = "; ".join(f"{chr(65 + i)}. {o}"
                         for i, o in enumerate(options)) + ";"
        return BR_PROMPT_TEMPLATE.format(question, opts)
    if task == "REC":
        q = "How many times did they " + anno["activity"] + "?"
        return REC_PROMPT_TEMPLATE.format(q)
    if task == "SSR":
        return SSR_PROMPT_TEMPLATE.format(anno["test_info"][index]["step"])
    if task == "CRR":
        return CRR_PROMPT_TEMPLATE.format(anno["question"])
    raise ValueError(task)


def split_contiguous(items: List, rank: int, world: int) -> List:
    """Contiguous split (reference inference_distributed.py:200-211)."""
    n = len(items)
    per = n // world
    extra = n % world
    start = rank * per + min(rank, extra)
    end = start + per + (1 if rank < extra else 0)
    return items[start:end]


class OVOBenchEval:
    def __init__(self, model, *, sample_fps: float = 1.0,
                 chunked_dir: Optional[str] = None,
                 frame_loader: Optional[Callable] = None):
        self.model = model
        self.sample_fps = sample_fps
        self.chunked_dir = chunked_dir
        self.frame_loader = frame_loader

    def _answer(self, video_ref, prompt: str, realtime_s: float,
                max_new_tokens: int = 16) -> str:
        if self.frame_loader is not None:
            frames = self.frame_loader(video_ref, realtime_s, self.sample_fps)
        else:
            path = (os.path.join(self.chunked_dir, video_ref)
                    if self.chunked_dir else video_ref)
            frames = load_video_frames(path, self.sample_fps)
        self.model.clear_cache()
        self.model.encode_init_prompt()
        self.model.encode_video(frames)
        pred = self.model.question_answering(
            {"question": prompt,
             "prompt": self.model.get_prompt(prompt, mc=False)},
            max_new_tokens=max_new_tokens)
        return pred.strip()

    def eval(self, anno: Dict[str, List[dict]], output_path: str):
        """anno: {'backward': [...], 'realtime': [...], 'forward': [...]}
        with reference schema (id, video, task, question, options, gt,
        realtime | test_info)."""
        results = {"backward": [], "realtime": [], "forward": []}

        for group in ("backward", "realtime"):
            for a in anno.get(group, []):
                prompt = build_prompt(a["task"], a["question"], a["options"])
                try:
                    resp = self._answer(f"{a['id']}.mp4", prompt,
                                        a.get("realtime", 0))
                except Exception as e:
                    resp = None
                    print(f"Error during inference: {e}")
                results[group].append({
                    "id": a["id"], "video": a["video"], "task": a["task"],
                    "question": a["question"], "response": resp,
                    "ground_truth": chr(65 + a["gt"]),
                })

        for a in anno.get("forward", []):
            row = dict(a)
            row["test_info"] = [dict(t) for t in a["test_info"]]
            for i, info in enumerate(row["test_info"]):
                prompt = build_prompt(a["task"], anno=a, index=i)
                try:
                    info["response"] = self._answer(
                        f"{a['id']}_{i}.mp4", prompt, info.get("realtime", 0))
                except Exception as e:
                    info["response"] = None
                    print(f"Error during inference: {e}")
            results["forward"].append(row)

        with open(output_path, "w") as f:
            json.dump(results, f, indent=2)
        return results
