"""Per-dataset report generators + GPT-judged open-ended scoring.

Device-agnostic eval breadth matching the reference's per-dataset scripts
(model/video_qa/eval/):

- videomme_sweep / save_heatmap  — retrieve_size x chunk_size accuracy pivot
  (+ seaborn/matplotlib heatmap when available), eval_videomme.py:8-40.
- mlvu_by_task                   — per-task accuracy table,
  eval_mlvu_by_task.py:72-74.
- egoschema_report               — summary metrics, per-category accuracies,
  top error samples, and a markdown report (a compact equivalent of the
  678-line eval_egoschema_subset.py generator).
- gpt_judge_open_ended           — GPT-judged open-ended scoring
  (eval_open_ended.py): the reference judge prompt verbatim, driven through
  any OpenAI-compatible endpoint (OPENAI_API_KEY / OPENAI_BASE_URL), with
  the deterministic containment scorer as offline fallback.
"""

from __future__ import annotations

import ast
import json
import os
from collections import defaultdict
from typing import Callable, Dict, List, Optional

MLVU_TASKS = ["plotQA", "findNeedle", "ego", "count", "order",
              "anomaly_reco", "topic_reasoning"]


# ---------------------------------------------------------------------------
# VideoMME retrieve_size x chunk_size sweep
# ---------------------------------------------------------------------------

def videomme_sweep(rows: List[dict], metric: str = "qa_acc"
                   ) -> Dict[int, Dict[int, float]]:
    """rows carry `retrieve_size`, `chunk_size`, and `metric` per question
    (the runner writes one row per question across the sweep grid).
    Returns pivot[chunk_size][retrieve_size] = mean metric (percent-scaled
    like the reference heatmap)."""
    groups = defaultdict(list)
    for r in rows:
        groups[(int(r["retrieve_size"]), int(r["chunk_size"]))].append(
            float(r[metric]))
    pivot: Dict[int, Dict[int, float]] = defaultdict(dict)
    for (rs, cs), vals in sorted(groups.items()):
        pivot[cs][rs] = 100.0 * sum(vals) / len(vals)
    return {cs: dict(v) for cs, v in pivot.items()}


def save_heatmap(pivot: Dict[int, Dict[int, float]], path: str,
                 title: str = "Average qa_acc") -> bool:
    """Render the sweep pivot as a heatmap PNG (reference eval_videomme
    seaborn plot).  Returns False (and writes nothing) when matplotlib is
    unavailable — the numeric pivot is the artifact of record either way."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        import numpy as np
    except ImportError:
        return False
    chunk_sizes = sorted(pivot)
    retrieve_sizes = sorted({rs for v in pivot.values() for rs in v})
    grid = np.full((len(chunk_sizes), len(retrieve_sizes)), np.nan)
    for i, cs in enumerate(chunk_sizes):
        for j, rs in enumerate(retrieve_sizes):
            if rs in pivot[cs]:
                grid[i, j] = pivot[cs][rs]
    fig, ax = plt.subplots(figsize=(10, 8))
    im = ax.imshow(grid, cmap="RdPu", origin="lower", aspect="auto")
    for i in range(len(chunk_sizes)):
        for j in range(len(retrieve_sizes)):
            if not np.isnan(grid[i, j]):
                ax.text(j, i, f"{grid[i, j]:.1f}", ha="center", va="center")
    ax.set_xticks(range(len(retrieve_sizes)), retrieve_sizes)
    ax.set_yticks(range(len(chunk_sizes)), chunk_sizes)
    ax.set_xlabel("Retrieve Size")
    ax.set_ylabel("Chunk Size")
    ax.set_title(title)
    fig.colorbar(im, ax=ax)
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
    return True


# ---------------------------------------------------------------------------
# MLVU per-task accuracy
# ---------------------------------------------------------------------------

def mlvu_by_task(rows: List[dict], metric: str = "qa_acc",
                 tasks: List[str] = MLVU_TASKS) -> Dict[str, Optional[float]]:
    """Per-task mean metric (reference eval_mlvu_by_task.py task loop)."""
    out: Dict[str, Optional[float]] = {}
    for task in tasks:
        vals = [float(r[metric]) for r in rows if r.get("task") == task]
        out[task] = 100.0 * sum(vals) / len(vals) if vals else None
    done = [v for v in out.values() if v is not None]
    out["overall"] = sum(done) / len(done) if done else None
    return out


# ---------------------------------------------------------------------------
# EgoSchema report
# ---------------------------------------------------------------------------

def egoschema_report(rows: List[dict], output_dir: Optional[str] = None,
                     top_n_errors: int = 10) -> Dict:
    """Summary + per-category accuracy + hardest error samples; optionally
    writes report.md + report.json (compact equivalent of
    eval_egoschema_subset.py's analyzer)."""
    total = len(rows)
    correct = sum(int(r.get("qa_acc", 0)) for r in rows)
    by_cat = defaultdict(lambda: {"total": 0, "correct": 0})
    for r in rows:
        cat = r.get("category", r.get("task", "all"))
        by_cat[cat]["total"] += 1
        by_cat[cat]["correct"] += int(r.get("qa_acc", 0))
    cats = {c: {"total": v["total"], "correct": v["correct"],
                "accuracy": 100.0 * v["correct"] / v["total"]}
            for c, v in sorted(by_cat.items())}
    errors = [r for r in rows if not r.get("qa_acc", 0)]
    errors = errors[:top_n_errors]
    report = {
        "total_samples": total,
        "correct_samples": correct,
        "accuracy": 100.0 * correct / total if total else None,
        "by_category": cats,
        "top_errors": [{k: r.get(k) for k in
                        ("video_id", "question", "pred_choice",
                         "correct_choice")} for r in errors],
    }
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        with open(os.path.join(output_dir, "report.json"), "w") as f:
            json.dump(report, f, indent=1)
        lines = ["# EgoSchema report", "",
                 f"Samples: {total}  Correct: {correct}  "
                 f"Accuracy: {report['accuracy']:.2f}%", "",
                 "| category | n | correct | acc |", "|---|---|---|---|"]
        for c, v in cats.items():
            lines.append(f"| {c} | {v['total']} | {v['correct']} | "
                         f"{v['accuracy']:.2f}% |")
        if errors:
            lines += ["", "## Hardest errors", ""]
            for r in errors:
                lines.append(f"- `{r.get('video_id')}`: "
                             f"pred {r.get('pred_choice')} vs "
                             f"gt {r.get('correct_choice')} — "
                             f"{str(r.get('question'))[:120]}")
        with open(os.path.join(output_dir, "report.md"), "w") as f:
            f.write("\n".join(lines) + "\n")
    return report


# ---------------------------------------------------------------------------
# GPT-judged open-ended scoring
# ---------------------------------------------------------------------------

JUDGE_SYSTEM = (
    "You are an intelligent chatbot designed for evaluating the correctness "
    "of generative outputs for question-answer pairs. "
    "Your task is to compare the predicted answer with the correct answer "
    "and determine if they match meaningfully. Here's how you can "
    "accomplish the task:"
    "------"
    "##INSTRUCTIONS: "
    "- Focus on the meaningful match between the predicted answer and the "
    "correct answer.\n"
    "- Consider synonyms or paraphrases as valid matches.\n"
    "- Evaluate the correctness of the prediction compared to the answer."
)

JUDGE_USER = (
    "Please evaluate the following video-based question-answer pair:\n\n"
    "Question: {question}\n"
    "Correct Answer: {answer}\n"
    "Predicted Answer: {pred}\n\n"
    "Provide your evaluation only as a yes/no and score where the score is "
    "an integer value between 0 and 5, with 5 indicating the highest "
    "meaningful match. "
    "Please generate the response in the form of a Python dictionary string "
    "with keys 'pred' and 'score', where value of 'pred' is  a string of "
    "'yes' or 'no' and value of 'score' is in INTEGER, not STRING."
    "DO NOT PROVIDE ANY OTHER OUTPUT TEXT OR EXPLANATION. Only provide the "
    "Python dictionary string. "
    "For example, your response should look like this: "
    "{{'pred': 'yes', 'score': 4.8}}."
)


def parse_judge_response(text: str) -> Dict:
    """'{'pred': 'yes', 'score': 4}' -> dict; raises on malformed output."""
    d = ast.literal_eval(text.strip())
    assert isinstance(d, dict) and "pred" in d and "score" in d, d
    return {"pred": str(d["pred"]).lower(), "score": float(d["score"])}


def make_openai_judge(model: str = "gpt-3.5-turbo-0613",
                      max_retries: int = 10) -> Optional[Callable]:
    """Build a judge callable from OPENAI_API_KEY (+ optional
    OPENAI_BASE_URL), reference GPTService.  Returns None when the key or
    the openai package is unavailable (caller falls back)."""
    api_key = os.environ.get("OPENAI_API_KEY")
    if not api_key:
        return None
    try:
        import openai
    except ImportError:
        return None
    client = openai.OpenAI(api_key=api_key,
                           base_url=os.environ.get("OPENAI_BASE_URL"))

    def judge(question: str, answer: str, pred: str) -> Dict:
        import time
        messages = [
            {"role": "system", "content": JUDGE_SYSTEM},
            {"role": "user", "content": JUDGE_USER.format(
                question=question, answer=answer, pred=pred)},
        ]
        for _ in range(max_retries):
            try:
                completion = client.chat.completions.create(
                    model=model, messages=messages, max_tokens=300,
                    temperature=0)
                return parse_judge_response(
                    completion.choices[0].message.content)
            except Exception:
                time.sleep(1)
        return {"pred": "no", "score": 0.0}

    return judge


def gpt_judge_open_ended(rows: List[dict],
                         judge: Optional[Callable] = None) -> Dict:
    """Score open-ended rows ({question, answer, pred_answer}).

    judge: callable(question, answer, pred) -> {'pred': 'yes'/'no',
    'score': float}.  Defaults to make_openai_judge(); when no judge is
    available, falls back to deterministic containment (answer substring of
    prediction) with score 5/0 — clearly flagged in the output."""
    if judge is None:
        judge = make_openai_judge()
    fallback = judge is None

    def contain(question, answer, pred):
        hit = str(answer).strip().lower() in str(pred).strip().lower()
        return {"pred": "yes" if hit else "no", "score": 5.0 if hit else 0.0}

    fn = contain if fallback else judge
    verdicts = []
    for r in rows:
        v = fn(r["question"], r["answer"], r.get("pred_answer", ""))
        verdicts.append({**r, "judge_pred": v["pred"],
                         "judge_score": v["score"]})
    n = len(verdicts)
    yes = sum(1 for v in verdicts if v["judge_pred"] == "yes")
    return {
        "judge": "containment-fallback" if fallback else "gpt",
        "accuracy": 100.0 * yes / n if n else None,
        "avg_score": sum(v["judge_score"] for v in verdicts) / n if n else None,
        "rows": verdicts,
    }
