"""What data parallelism costs at one rank, on the card: dqn/pong at the
CLI defaults (128 streams, replay 1e6, batch 1024, min fill 0.2 %) through
a plain Engine and through DistributedTrainer at world size 1 over NCCL,
from one state copied into both, in alternating windows (engine, trainer,
trainer, engine, ...) of supersteps past the min fill.

  python3 tools/torch_dist_ab.py [--windows=8] [--supersteps=100]

Prints one JSON line per window (ms per superstep, host clock, fenced by a
synchronize at both ends) and a summary line: the medians of each side, and
the cat + all-reduce + split of the gradients alone at the net's size
(CUDA events). Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import socket
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _free_port() -> int:
  with socket.socket() as sock:
    sock.bind(("localhost", 0))
    return sock.getsockname()[1]


def main() -> int:
  p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  p.add_argument("--windows", type=int, default=8)
  p.add_argument("--supersteps", type=int, default=100)
  args = p.parse_args()
  if not torch.cuda.is_available():
    print("torch_dist_ab: no CUDA card.", file=sys.stderr)
    return 1
  import torch.distributed as dist
  from dqn_zoo_torch.engine import Engine
  from dqn_zoo_torch.run import checkpoint as ckpt
  from dqn_zoo_torch.run import train_dist
  from dqn_zoo_torch.utils.pytree import leaves

  card = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
      capture_output=True, text=True, check=True).stdout.strip()
  dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                          f"{_free_port()}", rank=0, world_size=1)
  try:
    trainer = train_dist.build_trainer(
        "dqn", "pong", 1, 128, 1_000_000, min_replay_capacity_fraction=0.002,
        device="cuda")
    engine = Engine(dataclasses.replace(trainer.engine.config,
                                        pmap_axis=None), device="cuda")
    t_state = trainer.run(trainer.init(seed=1), 20)  # past the min fill
    e_state = ckpt.restore_state(engine.init(seed=2),
                                 ckpt.flatten_state(t_state))
    torch.cuda.synchronize()
    sides = {"engine": (engine.run, [e_state]),
             "trainer": (trainer.run, [t_state])}
    times = {"engine": [], "trainer": []}
    order = ["engine", "trainer", "trainer", "engine"]
    for w in range(args.windows):
      side = order[w % 4]
      run, holder = sides[side]
      torch.cuda.synchronize()
      t0 = time.perf_counter()
      holder[0] = run(holder[0], args.supersteps)
      torch.cuda.synchronize()
      ms = 1e3 * (time.perf_counter() - t0) / args.supersteps
      times[side].append(ms)
      print(json.dumps(dict(window=w, side=side, ms_per_superstep=ms,
                            learn_steps=holder[0].telemetry.learn_steps)),
            flush=True)

    grads = [torch.randn_like(x) for x in leaves(t_state.online_params)]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(5):
      trainer.engine._mean_over_ranks(grads)
    start.record()
    for _ in range(50):
      trainer.engine._mean_over_ranks(grads)
    end.record()
    torch.cuda.synchronize()
    print(json.dumps(dict(
        summary=True, card=card, supersteps_per_window=args.supersteps,
        engine_median_ms=statistics.median(times["engine"]),
        trainer_median_ms=statistics.median(times["trainer"]),
        engine_ms=times["engine"], trainer_ms=times["trainer"],
        mean_over_ranks_ms=start.elapsed_time(end) / 50,
        grad_floats=sum(g.numel() for g in grads))), flush=True)
  finally:
    dist.destroy_process_group()
  return 0


if __name__ == "__main__":
  sys.exit(main())
