"""Data-parallel training CLI (port of dqn_zoo_tpu/run/train_dist.py).

  torchrun --nproc_per_node=N -m dqn_zoo_torch.run.train --mesh_devices=N \\
      --agent=dqn --environment_name=pong

(`torchrun` is `python -m torch.distributed.run`.) run/train.py dispatches
here when --mesh_devices is set: the single-device CLI's iteration protocol
(train.run_protocol) over a DistributedTrainer, one process a rank
(parallel/distributed.py; NCCL, one card a rank, or gloo on the CPU with
--device=cpu). The process group is torchrun's, or one the caller joined
before; it must have exactly --mesh_devices ranks.

Semantics: --num_envs, --replay_capacity and --batch_size are GLOBAL
counts, split evenly over the ranks; the schedules count global frames
(frame_multiplier), so curves compare with single-device runs at the same
flags. Every decision that ends a loop (the wall-clock budget, a save
interval, the eval phase's extension) is taken on the first rank and
broadcast. Only the first rank writes the CSV; every rank writes its own
checkpoint file (run/checkpoint.py's RankCheckpoint).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from dqn_zoo_torch.device import resolve_device
from dqn_zoo_torch.parallel.distributed import (DistributedTrainer,
                                                init_distributed)
from dqn_zoo_torch.run import train as single
from dqn_zoo_torch.run.checkpoint import NullCheckpoint, RankCheckpoint


def build_trainer(agent_name: str, game: str, num_ranks: int,
                  num_envs_global: int, replay_capacity: int, *args,
                  device=None, **kwargs) -> DistributedTrainer:
  """This rank's DistributedTrainer: run.train.build_config's arithmetic
  on the global counts, split over `num_ranks` (the JAX build_trainer's);
  the other arguments are build_config's."""
  return DistributedTrainer(single.build_config(
      agent_name, game, num_envs_global, replay_capacity, *args,
      num_ranks=num_ranks, **kwargs), device=device)


def main_dist(args, spec_overrides: dict):
  """The iteration protocol on every rank; `args` are run.train's parsed
  flags. Joins torchrun's process group when none is joined yet (and
  leaves it at the end); returns this rank's final engine state."""
  d = args.mesh_devices
  joined = False
  if dist.is_initialized():
    device = resolve_device(args.device)
    if device.type == "cuda" and device.index is None:
      device = torch.device("cuda", torch.cuda.current_device())
  elif "WORLD_SIZE" in os.environ:
    device = init_distributed(args.device)
    joined = True
  else:
    raise ValueError(f"--mesh_devices={d} needs a process group of {d} "
                     f"ranks: launch with torchrun --nproc_per_node={d}.")
  try:
    if dist.get_world_size() != d:
      raise ValueError(f"--mesh_devices={d} but the process group has "
                       f"{dist.get_world_size()} ranks.")
    trainer = build_trainer(
        args.agent, args.environment_name, d, args.num_envs,
        args.replay_capacity, args.batch_size, args.replay_ratio_mode,
        args.max_frames_per_episode, args.num_iterations,
        args.num_train_frames, args.min_replay_capacity_fraction,
        spec_overrides=spec_overrides, resize_method=args.resize_method,
        device=device)
    checkpoint = (RankCheckpoint(args.checkpoint_path, device=trainer.device)
                  if args.checkpoint_path else NullCheckpoint())
    return single.run_protocol(args, trainer, checkpoint)
  finally:
    if joined:
      dist.destroy_process_group()
