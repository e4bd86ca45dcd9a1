from stc_tpu_torch.eval.datasets import DATASETS, DatasetConfig
from stc_tpu_torch.eval.scorers import (
    multiple_choice_accuracy,
    streamingbench_score,
    ovobench_score,
)
