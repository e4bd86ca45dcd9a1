"""Benchmark scorers — pure functions over result rows.

Re-implementations of the reference's scoring rules so shipped golden result
files re-score identically:
- multiple-choice accuracy over solver rows (eval_multiple_choice.py /
  qa_acc column from rekv_offline_refactored.py:48-62);
- StreamingBench per-task exact option match
  (streamingbench/src/data/count.py:68-92);
- OVO-Bench substring / digit-extraction / Yes-No rules
  (ovobench/utils/OVOBenchScore.py:14-70) — with the reference's
  empty-task-group crash (undefined backward_score) fixed: missing groups
  contribute nothing to the average.
"""

from __future__ import annotations

import re
from collections import defaultdict
from typing import Callable, Dict, Iterable, List, Optional


# ---------------------------------------------------------------------------
# Offline VQA
# ---------------------------------------------------------------------------

def multiple_choice_accuracy(rows: Iterable[dict]) -> Dict[str, float]:
    """rows: solver result dicts with 'pred_choice' and 'correct_choice'."""
    total = correct = 0
    for r in rows:
        total += 1
        correct += int(r["pred_choice"] == r["correct_choice"])
    return {"accuracy": 100.0 * correct / total if total else 0.0,
            "n": total}


def open_ended_accuracy(rows: Iterable[dict],
                        judge: Optional[Callable[[str, str, str], bool]]
                        = None) -> Dict[str, float]:
    """Open-ended QA scoring (reference eval_open_ended.py used a GPT judge).

    Without a judge callable, falls back to normalized containment matching
    (answer within prediction or vice versa).  `judge(question, answer,
    prediction) -> bool` plugs in an LLM judge when an API is available.
    """
    total = correct = 0
    for r in rows:
        ans = (r.get("answer") or "").strip().lower()
        pred = (r.get("pred_answer") or "").strip().lower()
        if not ans:
            continue
        total += 1
        if judge is not None:
            ok = judge(r.get("question", ""), ans, pred)
        else:
            ok = bool(pred) and (ans in pred or pred in ans)
        correct += int(ok)
    return {"accuracy": 100.0 * correct / total if total else 0.0,
            "n": total}


def extract_choice(pred_text: str) -> str:
    """Reference BaseVQA.extract_choice (base_refactored.py:82-88)."""
    pred_text = pred_text.strip()
    if ")" in pred_text:
        idx = pred_text.index(")")
        return pred_text[idx - 1:idx]
    return pred_text[0] if pred_text else "A"


# ---------------------------------------------------------------------------
# StreamingBench
# ---------------------------------------------------------------------------

def _first(ans):
    if ans is None:
        return None
    a = ans[0] if isinstance(ans, list) else ans
    return a.strip()


def streamingbench_score(data: List[dict], model_key: str) -> Dict[str, dict]:
    """data: list of entries, each with 'questions': [{task_type, answer,
    <model_key>: predicted}].  Exact match of the stripped option letter."""
    stats: Dict[str, dict] = defaultdict(lambda: {"total": 0, "correct": 0})
    for entry in data:
        for q in entry.get("questions", []):
            if model_key not in q or not q.get(model_key):
                continue
            pred = _first(q[model_key])
            if not pred:
                continue
            tt = q["task_type"]
            for key in (tt, "total"):
                stats[key]["total"] += 1
                if pred == q["answer"]:
                    stats[key]["correct"] += 1
    for counts in stats.values():
        counts["accuracy"] = (100.0 * counts["correct"] / counts["total"]
                              if counts["total"] else 0.0)
    return dict(stats)


def streamingbench_score_sqa(data: List[List[dict]],
                             model_key: str) -> Dict[str, dict]:
    """Sequential-QA variant: data is a list of dialogs, each a list of
    entries (count.py 'sqa' branch)."""
    flat = [entry for dialog in data for entry in dialog]
    return streamingbench_score(flat, model_key)


def streamingbench_score_proactive(data: List[dict], model_key: str,
                                   tolerance_s: int = 2) -> Dict[str, dict]:
    """Proactive-output variant (count.py 'proactive' branch): the model's
    last dialog turn must land within ±tolerance_s of the ground-truth
    timestamp AND contain the ground-truth output."""
    stats: Dict[str, dict] = defaultdict(
        lambda: {"total": 0, "time_correct": 0, "answer_correct": 0})
    for entry in data:
        for q in entry.get("questions", []):
            if model_key not in q:
                continue
            pred = q[model_key]
            if not pred:
                continue
            gt_ts = q["ground_truth_time_stamp"]
            gt_time = sum(int(x) * 60 ** i
                          for i, x in enumerate(reversed(gt_ts.split(":"))))
            hist = pred["dialog_history"]
            last_time = hist[-1]["time"]
            last_answer = hist[-1]["content"]
            tt = q["task_type"]
            stats[tt]["total"] += 1
            if -tolerance_s <= last_time - gt_time <= tolerance_s:
                stats[tt]["time_correct"] += 1
                if q["ground_truth_output"] in last_answer:
                    stats[tt]["answer_correct"] += 1
    for c in stats.values():
        c["time_accuracy"] = (c["time_correct"] / c["total"]
                              if c["total"] else 0.0)
        c["answer_accuracy"] = (c["answer_correct"] / c["total"]
                                if c["total"] else 0.0)
    return dict(stats)


# ---------------------------------------------------------------------------
# OVO-Bench
# ---------------------------------------------------------------------------

def _score_contains(response: Optional[str], gt: str) -> int:
    return int(gt in response) if response else 0


def _score_rec(response: Optional[str], gt) -> int:
    if not response:
        return 0
    digits = "".join(re.findall(r"\d+", response))
    return int(digits == str(gt))


def _score_yes_no(response: Optional[str], type_flag: int) -> int:
    if response is None:
        return 0
    if (response == "N" and type_flag == 0) or (response == "Y"
                                                and type_flag == 1):
        return 1
    gt = "No" if type_flag == 0 else "Yes"
    return _score_contains(response, gt)


def ovobench_score(results: Dict[str, List[dict]]) -> Dict[str, dict]:
    """results: {'backward': [...], 'realtime': [...], 'forward': [...]}.

    backward/realtime rows: {task, response, ground_truth}.
    forward rows: {task, test_info: [{response, count?|type?}]}.
    """
    out: Dict[str, dict] = {}
    group_avgs = []

    for group in ("backward", "realtime"):
        per_task: Dict[str, list] = defaultdict(list)
        for r in results.get(group, []):
            per_task[r["task"]].append(
                _score_contains(r.get("response"), r["ground_truth"]))
        if per_task:
            task_accs = {t: 100.0 * sum(v) / len(v)
                         for t, v in per_task.items()}
            avg = sum(task_accs.values()) / len(task_accs)
            out[group] = {"tasks": task_accs, "avg": avg}
            group_avgs.append(avg)

    per_task = defaultdict(list)
    for r in results.get("forward", []):
        task = r["task"]
        for info in r.get("test_info", []):
            if task == "REC":
                per_task["REC"].append(
                    _score_rec(info.get("response"), info["count"]))
            elif task in ("SSR", "CRR"):
                per_task[task].append(
                    _score_yes_no(info.get("response"), info["type"]))
    if per_task:
        task_accs = {t: 100.0 * sum(v) / len(v) for t, v in per_task.items()}
        avg = sum(task_accs.values()) / len(task_accs)
        out["forward"] = {"tasks": task_accs, "avg": avg}
        group_avgs.append(avg)

    out["total_avg"] = (sum(group_avgs) / len(group_avgs)
                        if group_avgs else 0.0)
    return out
