#!/bin/bash
# Chained checkpoint-split training of the PyTorch port: legs of
# `python -m dqn_zoo_torch.run.train`, each resuming from the last one's
# checkpoint, at the flags of the JAX package's learning runs
# (tools/chain_train.sh: 128 envs, replay 1e6, 2M train frames and 5e5 eval
# frames on 16 envs per iteration, replay-less checkpoints).
#
#   tools/torch_chain_train.sh [AGENT] [GAME] [RUNS] [NUM_ITERS] [SEED]
#
# Each leg runs under a wall-clock budget of 1,200 s (--max_run_seconds,
# from the first fence after the engine is built) with mid-train saves
# every 300 s and at once after each train phase's first chunk, so a leg
# that is killed loses at most one save interval. The chain stops once the
# checkpoint's meta file records an iteration past NUM_ITERS, or after RUNS
# legs. The budget fits a command cut at 1,500 s: a leg checks it only
# between train chunks and before eval, so it can overrun it by one eval
# phase (7,813 eval supersteps, ~100 s on an H100) and one save (0.1 s
# without the replay, 9 s with it), on top of the process start, the
# kernels' build (~8 s) and the restore. The replay is left out of the
# checkpoints (31.5 MB for dqn against 7.1 GB with it) and refilled under
# the min fill, as in the JAX runs.
#
# Environment: CKPT (checkpoint directory), CSV (results file), EXTRA_FLAGS
# (more flags for every leg; a flag given there overrides the one above,
# e.g. --max_run_seconds=400 or --iterations_per_run=1).
set -u
AGENT=${1:-dqn}
GAME=${2:-pong}
RUNS=${3:-1}
NUM_ITERS=${4:-24}
SEED=${5:-3}
ROOT=$(cd "$(dirname "$0")/.." && pwd)
CKPT=${CKPT:-$ROOT/.ckpt/torch_${AGENT}_${GAME}_s${SEED}}
CSV=${CSV:-$ROOT/results/torch_${AGENT}_${GAME}_$((NUM_ITERS * 2))M_seed${SEED}.csv}
cd "$ROOT" || exit 1
rc=0
for i in $(seq 1 "$RUNS"); do
  echo "=== leg $i/$RUNS $(date)"
  python3 -m dqn_zoo_torch.run.train --agent="$AGENT" \
    --environment_name="$GAME" --num_envs=128 --replay_capacity=1000000 \
    --seed="$SEED" --num_iterations="$NUM_ITERS" --num_train_frames=2000000 \
    --num_eval_frames=500000 --eval_num_envs=16 \
    --max_run_seconds=1200 --save_interval_seconds=300 \
    --checkpoint_path="$CKPT" --results_csv_path="$CSV" \
    --checkpoint_replay=false --checkpoint_period=1 \
    ${EXTRA_FLAGS:-}
  rc=$?
  echo "=== leg $i exited rc=$rc $(date)"
  # The meta file holds the next iteration to run; past NUM_ITERS, done.
  DONE=$(python3 - "$CKPT/meta.json" "$NUM_ITERS" <<'EOF'
import json, sys
try:
  print(int(json.load(open(sys.argv[1]))["iteration"] > int(sys.argv[2])))
except (OSError, ValueError, KeyError):
  print(0)
EOF
)
  if [ "$DONE" = "1" ]; then
    echo "=== chain complete $(date)"
    break
  fi
  [ "$rc" = "0" ] || break
done
exit "$rc"
