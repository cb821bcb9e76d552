"""Learning probe of the port's single-stream agent surface on the card:
HostAgent dqn/catch at the JAX package's test_host_agent_learns_catch
settings (tests/test_host_agent.py:48-73): 19,000 frames, learning rate
2e-3, batch 32, learn period 8, target period 500, min fill 5 % of a
2,000-transition replay, ε decaying over 25 % of 40,000 frames, catch
with 1..3 noop starts (env seed 1), episodes cut at 500 frames, agent seed
0. The JAX run recorded a 20-episode mean return of -0.7 at the start and
+0.5 around 17k frames (tests/test_host_agent.py:49-50).

It prints one JSON line every 1,000 frames (frames, episodes, the mean
return of the last 20 episodes, the last loss, seconds) and a last line
with the first and last 20-episode mean returns, the frames per second and
the card's name and power limit; `--out` also appends that last line to a
file.

Usage:
  python3 tools/torch_host_agent_catch.py [--frames=19000] [--out=PATH]
Runs on the card; `--device=cpu` rehearses it on the CPU (no device
numbers). Imports nothing of JAX or of dqn_zoo_tpu.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
  parser = argparse.ArgumentParser()
  parser.add_argument("--frames", type=int, default=19_000)
  parser.add_argument("--device", default="cuda")
  parser.add_argument("--out", default=None)
  args = parser.parse_args()

  import numpy as np
  import torch
  from dqn_zoo_torch import parts, processors
  from dqn_zoo_torch.agents import get_agent
  from dqn_zoo_torch.envs.dm_adapter import GameEnvironment
  from dqn_zoo_torch.host_agent import HostAgent

  if args.device == "cpu":
    card = "none: a CPU rehearsal, no device numbers"
  else:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
  spec = dataclasses.replace(
      get_agent("dqn"), learning_rate=2e-3, batch_size=32, learn_period=8,
      target_network_update_period=500, min_replay_capacity_fraction=0.05,
      exploration_epsilon_decay_frame_fraction=0.25)
  env = GameEnvironment("catch", seed=1, max_noops=3, device=args.device)
  agent = HostAgent(spec, 3, np.zeros((84, 84, 4), np.uint8), seed=0,
                    preprocessor=processors.atari(), replay_capacity=2000,
                    total_frames=40_000, device=args.device)
  returns, cur, frames = [], 0.0, 0
  t0 = time.perf_counter()
  for _, ts, _, _ in parts.run_loop(agent, env, max_steps_per_episode=500):
    frames += 1
    if ts.reward:
      cur += ts.reward
    if ts.last():
      returns.append(cur)
      cur = 0.0
    if frames % 1000 == 0:
      print(json.dumps(dict(
          frames=frames, episodes=len(returns),
          mean_return_last_20=float(np.mean(returns[-20:])) if returns
          else None, loss=agent._statistics.get("loss"),
          seconds=time.perf_counter() - t0)), flush=True)
    if frames >= args.frames:
      break
  if args.device != "cpu":
    torch.cuda.synchronize()
  seconds = time.perf_counter() - t0
  line = dict(
      agent="dqn", game="catch", frames=frames, episodes=len(returns),
      first_20_mean_return=float(np.mean(returns[:20])),
      last_20_mean_return=float(np.mean(returns[-20:])),
      learned=bool(np.mean(returns[-20:]) > np.mean(returns[:20]) + 0.5
                   and np.mean(returns[-20:]) > -0.3),
      frames_per_s=frames / seconds, seconds=seconds,
      last_loss=agent._statistics.get("loss"), card=card,
      device=args.device)
  print(json.dumps(line), flush=True)
  if args.out:
    with open(args.out, "a") as f:
      f.write(json.dumps(line) + "\n")
  return 0


if __name__ == "__main__":
  sys.exit(main())
