"""Catch learning probe of the PyTorch port on the card: does an agent's
whole device path (its replay included) learn?

The port's counterpart of tools/diag_catch_tpu.py, at its operating point:
128 env streams, replay capacity 200k, 2,000-frame episode cap, parity mode
(the reference's batch of 32, 32 SGD steps per superstep), seed 3, one
iteration whose frame budget is the probe's, so ε and the IS exponent anneal
over it. Every ~40k frames (80 supersteps) it prints one JSON line: frames,
the mean return of the episodes completed so far, the last loss, ε, the
learn steps, the supersteps that took the env's reset branch and the
seconds so far. The first line names the card and its power limit; the
last line of an agent gives the fenced stage split (ms per superstep) over
40 learning supersteps, taken after the probe's last chunk.

Usage (one or more agents, each run in turn in this process):
  python3 tools/torch_diag_catch.py dqn prioritized rainbow --frames=600000 \\
      --out=torch_diag_catch.jsonl
Runs on the card; `--device=cpu` with small `--num_envs`,
`--replay_capacity` and `--chunk` rehearses it on the CPU. Imports nothing
of JAX or of dqn_zoo_tpu.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def _card(device: str) -> dict:
  import torch
  if device == "cpu":
    return {"card": "none: a CPU rehearsal, no device numbers"}
  smi = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
      capture_output=True, text=True, check=True)
  return {"card": torch.cuda.get_device_name(0),
          "nvidia_smi": smi.stdout.strip().splitlines()[0]}


def probe(agent: str, args, emit) -> None:
  import torch
  from dqn_zoo_torch.run.train import build_engine

  frames, chunk = args.frames, args.chunk
  engine = build_engine(agent, "catch", args.num_envs,
                        replay_capacity=args.replay_capacity,
                        num_iterations=1, num_train_frames=frames,
                        max_frames_per_episode=2000,
                        replay_ratio_mode="parity", device=args.device)
  cfg = engine.config
  emit({"agent": agent, "batch_size": cfg.batch_size,
        "updates_per_learn": cfg.updates_per_learn,
        "learning_rate": engine.spec.learning_rate,
        "priority_exponent": engine.spec.priority_exponent, "seed": 3})
  state = engine.init(seed=3)
  resets = []
  t0 = time.perf_counter()
  while state.env_frames < frames:
    for _ in range(chunk):
      resets.append(state.env.needs_reset.any())
      state = engine.superstep(state)
    m = engine.metrics(state)
    line = {"agent": agent, "frames": m.env_frames,
            "return": m.mean_episode_return, "loss": m.last_loss,
            "eps": m.exploration_epsilon, "learn_steps": m.learn_steps,
            "episodes": m.episodes,
            "supersteps": state.superstep,
            "reset_supersteps": int(torch.stack(resets).sum()),
            "seconds": time.perf_counter() - t0}
    if engine.rcfg.priority_exponent > 0:
      line["max_seen_priority"] = float(state.replay.max_seen_priority)
      line["is_exponent"] = engine.importance_sampling_exponent(
          state.replay.t * cfg.num_envs)
    emit(line)
  split = {}
  fenced = min(40, chunk)
  state = engine.run(state, fenced, timings=split)
  emit({"agent": agent, "fenced_supersteps": fenced,
        "split_ms_per_superstep": {k: 1e3 * v / fenced
                                   for k, v in split.items()},
        "learn_ms_per_sgd_step": 1e3 * split["learn"] / fenced
        / cfg.updates_per_learn})


def main() -> int:
  p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  p.add_argument("agents", nargs="*", default=["dqn"])
  p.add_argument("--frames", type=int, default=600_000)
  p.add_argument("--out", default="", help="Also append the lines here.")
  p.add_argument("--device", default="cuda", help="cuda (default) or cpu.")
  p.add_argument("--num_envs", type=int, default=128)
  p.add_argument("--replay_capacity", type=int, default=200_000)
  p.add_argument("--chunk", type=int, default=80,
                 help="Supersteps per line; 80 x 512 frames ~ 41k.")
  args = p.parse_args()
  sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
      __file__))))
  from dqn_zoo_torch import kernels
  from dqn_zoo_torch.device import resolve_device
  resolve_device(args.device)  # no card for cuda: raises, no fall back
  if args.device != "cpu":
    kernels.build_all()
  out = open(args.out, "a") if args.out else None

  def emit(obj):
    text = json.dumps(obj)
    print(text, flush=True)
    if out:
      out.write(text + "\n")
      out.flush()

  try:
    emit(_card(args.device))
    for agent in args.agents:
      probe(agent, args, emit)
  finally:
    if out:
      out.close()
  return 0


if __name__ == "__main__":
  sys.exit(main())
