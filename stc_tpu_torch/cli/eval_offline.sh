#!/usr/bin/env bash
# Offline benchmark evaluation of the port, data-parallel: one
# `python -m stc_tpu_torch.cli.run_eval` process per shard (RANK,
# WORLD_SIZE), each pinned to one card with CUDA_VISIBLE_DEVICES.
#
#   [NUM_PROCESSES=N] [SAVE_DIR=dir] bash stc_tpu_torch/cli/eval_offline.sh \
#       DATASET MODEL MODEL_PATH [run_eval arguments...]
#
# NUM_PROCESSES defaults to the number of cards `nvidia-smi -L` lists.
# It waits for every shard and exits non-zero if any failed; then it
# merges the rank files again (rank 0 merges as soon as its own shard
# ends, before the others may have) and prints the score.
set -euo pipefail

DATASET=${1:-mlvu}
MODEL=${2:-llava_ov_7b}
MODEL_PATH=${3:?model checkpoint dir}
shift 3
CARDS=$(nvidia-smi -L 2>/dev/null | grep -c '^GPU' || true)
NUM_PROCESSES=${NUM_PROCESSES:-$CARDS}
if [ "$NUM_PROCESSES" -lt 1 ]; then
  echo "eval_offline.sh: nvidia-smi -L lists no card; set NUM_PROCESSES" >&2
  exit 2
fi
SAVE_DIR=${SAVE_DIR:-results/${DATASET}}
ROOT=$(cd "$(dirname "${BASH_SOURCE[0]}")/../.." && pwd)
export PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}"

pids=()
for ((r = 0; r < NUM_PROCESSES; r++)); do
  CUDA_VISIBLE_DEVICES=$((r % (CARDS > 0 ? CARDS : NUM_PROCESSES))) \
    RANK=$r WORLD_SIZE=$NUM_PROCESSES \
    python3 -m stc_tpu_torch.cli.run_eval --dataset "$DATASET" \
    --model "$MODEL" --model_path "$MODEL_PATH" --save_dir "$SAVE_DIR" "$@" &
  pids+=($!)
done
failed=0
for p in "${pids[@]}"; do
  wait "$p" || failed=$((failed + 1))
done
if [ "$failed" -ne 0 ]; then
  echo "eval_offline.sh: $failed of $NUM_PROCESSES shards failed" >&2
  exit 1
fi
python3 -c '
import json, sys
from stc_tpu_torch.eval.runner import merge_and_score
out = merge_and_score(sys.argv[1], sys.argv[2])
print(json.dumps({k: v for k, v in out.items() if k != "rows"}))
' "$SAVE_DIR" "$DATASET"
