"""Dataset registry for the offline/stream VQA harness.

Equivalent of reference model/video_qa/configs.py:13-74 — each dataset names
its annotation file, solver and scorer.  Annotation schema (reference
data/*/*.json): {video_id, video_path, duration, conversations:
[{question, choices?, answer, start_time?, end_time?}]}.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DatasetConfig:
    name: str
    anno_path: str
    solver: str       # 'offline' | 'stream' | 'videomme'
    scorer: str       # 'multiple_choice' | 'open_ended'


DATASETS = {
    "videomme": DatasetConfig("videomme", "data/videomme/random_videomme.json",
                              "videomme", "multiple_choice"),
    "videomme_subset": DatasetConfig(
        "videomme_subset", "data/videomme/videomme_subset.json",
        "videomme", "multiple_choice"),
    "mlvu": DatasetConfig("mlvu", "data/mlvu/dev_debug_mc.json",
                          "offline", "multiple_choice"),
    "egoschema": DatasetConfig("egoschema", "data/egoschema/full.json",
                               "offline", "multiple_choice"),
    "egoschema_subset": DatasetConfig(
        "egoschema_subset", "data/egoschema_subset/egoschema_subset.json",
        "videomme", "multiple_choice"),
    "qaego4d": DatasetConfig("qaego4d", "data/qaego4d/test_mc.json",
                             "offline", "multiple_choice"),
    "cgbench": DatasetConfig("cgbench", "data/cgbench/full_mc.json",
                             "offline", "multiple_choice"),
    "activitynet_qa": DatasetConfig(
        "activitynet_qa", "data/activitynet_qa/test.json",
        "offline", "open_ended"),
    "rvs_ego": DatasetConfig("rvs_ego", "data/rvs/ego/ego4d_oe.json",
                             "stream", "open_ended"),
    "rvs_movie": DatasetConfig("rvs_movie", "data/rvs/movie/movienet_oe.json",
                               "stream", "open_ended"),
}
