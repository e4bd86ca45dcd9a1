"""Distributed eval runner — data-parallel over processes.

Equivalent of reference model/video_qa/run_distributed.py (torchrun+gloo):
annotations are strided across processes (anno[rank::world], reference
utils/data_utils.py:34), each process runs its solver shard and writes a
per-rank JSON; rank 0 merges and scores.  Gathering goes through the
shared filesystem instead of gloo gather_object — no collective needed for
an embarrassingly-parallel eval, and partially-finished ranks can be
re-merged (crash-resumable at the rank level, like the reference's
temp-file merge in streamingbench/src/eval.py:18-41).  The rank and world
size come from torch.distributed when a process group is up, else 0 / 1.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, List, Optional

import torch.distributed as dist

from stc_tpu_torch.eval.datasets import DATASETS
from stc_tpu_torch.eval.scorers import (multiple_choice_accuracy,
                                  open_ended_accuracy)
from stc_tpu_torch.eval.solvers import BatchedOfflineVQA, create_solver


def load_and_split_anno(anno_path: str, rank: int, world: int) -> List[dict]:
    with open(anno_path) as f:
        anno = json.load(f)
    return anno[rank::world]


def run_eval(
    dataset: str,
    model,
    save_dir: str,
    *,
    anno_path: Optional[str] = None,
    sample_fps: float = 0.5,
    rank: Optional[int] = None,
    world: Optional[int] = None,
    frame_loader: Optional[Callable] = None,
    max_samples: Optional[int] = None,
    stream_batch: int = 1,
    tags: Optional[dict] = None,
):
    """Run one dataset shard; returns (rows, rank_file).

    tags: fields added to every row (cli/run_eval passes its
    retrieve_size and chunk_size); None reads them from the STC_TOPK and
    STC_CHUNK_SIZE environment variables.

    stream_batch > 1: CONCURRENT eval — groups of stream_batch samples
    share one batched session (ragged multi-stream ingest + per-stream
    batched QA, solvers.BatchedOfflineVQA).  Rows are identical to the
    sequential solver's; the model's session must be built with
    batch == stream_batch.  Offline-protocol datasets only.  Note: a
    group's decoded frames are host-resident together (peak host memory
    ~stream_batch x sequential), and unequal-length groups must fit the
    device KV store (host-tier spill needs uniform streams — the solver
    fails fast with the knobs otherwise).
    """
    group = dist.is_available() and dist.is_initialized()
    if rank is None:
        rank = dist.get_rank() if group else 0
    if world is None:
        world = dist.get_world_size() if group else 1

    ds = DATASETS[dataset]
    anno = load_and_split_anno(anno_path or ds.anno_path, rank, world)
    if max_samples is not None:
        anno = anno[:max_samples]

    batched = stream_batch > 1
    if batched:
        assert ds.solver in ("offline", "videomme"), (
            f"stream_batch applies to offline-protocol datasets; "
            f"{dataset} uses the '{ds.solver}' solver")
        sess_batch = getattr(getattr(model, "session", None), "batch", None)
        assert sess_batch is None or sess_batch == stream_batch, (
            f"the model's session was built with batch={sess_batch} but "
            f"stream_batch={stream_batch}; build it with "
            f"batch=stream_batch (loaders take batch=)")
        solver = BatchedOfflineVQA(model, sample_fps, frame_loader)
        solver.instrumented = ds.solver == "videomme"
        groups = [anno[i:i + stream_batch]
                  for i in range(0, len(anno), stream_batch)]
    else:
        solver = create_solver(ds.solver, model, sample_fps, frame_loader)
        groups = [[s] for s in anno]
    os.makedirs(save_dir, exist_ok=True)
    rank_file = os.path.join(save_dir, f"results_rank{rank}.json")

    # tag rows with the sweep knobs so report generators can pivot over
    # retrieve_size x chunk_size (reference eval_videomme heatmaps)
    if tags is None:
        tags = {}
        if os.environ.get("STC_TOPK"):
            tags["retrieve_size"] = int(os.environ["STC_TOPK"])
        if os.environ.get("STC_CHUNK_SIZE"):
            tags["chunk_size"] = int(os.environ["STC_CHUNK_SIZE"])

    for group in groups:
        n0 = len(solver.results)
        try:
            if batched:
                solver.run_batch(group)
            else:
                solver(group[0])
        except Exception as e:  # error row(s) + continue, like the reference
            for sample in group:
                solver.results.append({
                    "video_id": sample.get("video_id"), "error": str(e)})
        if tags:
            for r in solver.results[n0:]:
                r.update(tags)
        # incremental dump -> crash-resumable at group granularity
        with open(rank_file, "w") as f:
            json.dump(solver.results, f)
    return solver.results, rank_file


def merge_and_score(save_dir: str, dataset: str):
    """Rank-0 merge of all per-rank files + scoring."""
    rows: List[dict] = []
    for name in sorted(os.listdir(save_dir)):
        if name.startswith("results_rank") and name.endswith(".json"):
            with open(os.path.join(save_dir, name)) as f:
                rows.extend(json.load(f))
    ds = DATASETS[dataset]
    scored = None
    if ds.scorer == "multiple_choice":
        scored = multiple_choice_accuracy(
            [r for r in rows if "pred_choice" in r])
    elif ds.scorer == "open_ended":
        scored = open_ended_accuracy(
            [r for r in rows if "pred_answer" in r])
    out = {"dataset": dataset, "n_rows": len(rows), "score": scored,
           "ts": time.time()}
    with open(os.path.join(save_dir, "merged_score.json"), "w") as f:
        json.dump({**out, "rows": rows}, f)
    return out
