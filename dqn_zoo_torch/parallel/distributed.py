"""Data-parallel training over ranks (port of
dqn_zoo_tpu/parallel/distributed.py).

The JAX package runs one program over a device mesh with shard_map; the
port runs one process a rank of a `torch.distributed` process group: NCCL
on the card, one card a rank, and gloo on the CPU for the tests. The
design is the JAX package's:

  Envs, frame stacks, replay, draws and telemetry live PER RANK (each rank
  holds its own EngineState, the port's form of JAX's (D, ...)-stacked
  `per_device`). Online and target parameters and the optimizer state are
  REPLICATED: built once, broadcast from the first rank, and kept equal by
  one mean all-reduce of the gradients per SGD step (engine/superstep.py,
  `pmap_axis`), the only traffic between ranks on the training path
  besides the learn gate's 8-byte MIN (Engine.gate_size). The metric and
  eval sums cross the ranks once per phase.

  The schedules count global frames with no collective: each rank scales
  its own counters by `EngineConfig.frame_multiplier` = the world size.

As in the JAX package, each rank swaps its target on its own frame count,
which ranks whose episodes end at different frames cross at different
supersteps: between two such crossings the ranks' targets may differ.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from dqn_zoo_torch.device import resolve_device
from dqn_zoo_torch.engine.superstep import (Engine, EngineConfig,
                                            EngineState, EvalState)
from dqn_zoo_torch.utils.pytree import leaves


def rank_seed(seed: int, rank: int) -> int:
  """The seed of `rank`'s envs, replay and draws: distinct per rank, and
  `seed` itself on the first rank."""
  return seed + 104_729 * rank


def init_distributed(device=None) -> torch.device:
  """Joins the process group that torchrun's variables describe (RANK,
  WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT) and
  returns this rank's device. A group already joined is kept.

  On the card (the default): NCCL and `cuda:{LOCAL_RANK}`, one card a
  rank. Raises where the ranks on this node outnumber its cards: there is
  no quiet switch to gloo or to the CPU. `device="cpu"`: gloo on the CPU.
  """
  if device is not None and torch.device(device).type == "cpu":
    dev, backend = torch.device("cpu"), "gloo"
  else:
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", local_rank + 1))
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if max(local_rank + 1, local_world) > cards:
      raise RuntimeError(
          f"{max(local_rank + 1, local_world)} ranks on this node, "
          f"{cards} CUDA cards: NCCL takes one card a rank (pass "
          "device='cpu' for gloo on the CPU).")
    dev = resolve_device(f"cuda:{local_rank}")
    torch.cuda.set_device(dev)
    backend = "nccl"
  if not dist.is_initialized():
    dist.init_process_group(backend, init_method="env://")
  return dev


class DistributedTrainer:
  """One rank's share of data-parallel training: an Engine whose SGD steps
  mean-all-reduce their gradients over `group`.

  `config.num_envs` is the PER-RANK stream count; `config.pmap_axis` must
  be set and `config.frame_multiplier` must equal the world size. Every
  method is called on every rank of the group together: the ones that
  cross ranks (init, run, the metrics, `agree`) are collectives. The CLI's
  iteration protocol (run/train.py's run_protocol) drives it as it drives
  one device through run.train.OneDevice.
  """

  def __init__(self, config: EngineConfig, group=None, device=None):
    if config.pmap_axis is None:
      raise ValueError("config.pmap_axis must be set for data parallelism.")
    self.engine = Engine(config, device=device, group=group)
    self.group = group
    self.world_size = self.engine.world_size
    if config.frame_multiplier != self.world_size:
      raise ValueError("config.frame_multiplier must equal the world size "
                       f"({config.frame_multiplier} != {self.world_size})")
    self.rank = dist.get_rank(group)
    self._src = 0 if group is None else dist.get_global_rank(group, 0)

  @property
  def device(self) -> torch.device:
    return self.engine.device

  def init(self, seed: int) -> EngineState:
    """This rank's state: envs, replay and generator from `rank_seed(seed,
    rank)`, so that the ranks' streams differ; the nets are the first
    rank's, broadcast in one flat buffer, so that they are equal bit for
    bit on every rank (the optimizer's fresh moments are zeros on all)."""
    state = self.engine.init(rank_seed(seed, self.rank))
    online = leaves(state.online_params)
    with torch.no_grad():
      flat = torch.cat([p.reshape(-1) for p in online])
      dist.broadcast(flat, src=self._src, group=self.group)
      for p, v, t in zip(online, flat.split([p.numel() for p in online]),
                         leaves(state.target_params)):
        p.copy_(v.view_as(p))
        t.copy_(p)
    return state

  def run(self, state: EngineState, num_supersteps: int,
          timings: Optional[Dict[str, float]] = None) -> EngineState:
    return self.engine.run(state, num_supersteps, timings=timings)

  # --- evaluation ------------------------------------------------------------

  def eval_init(self, seed: int, num_envs: Optional[int] = None) -> EvalState:
    """`num_envs` eval streams on this rank, from `rank_seed(seed, rank)`."""
    return self.engine.eval_init(rank_seed(seed, self.rank), num_envs)

  def eval_run(self, params, estate: EvalState,
               num_supersteps: int) -> EvalState:
    """Actor-only: no collective."""
    return self.engine.eval_run(params, estate, num_supersteps)

  # --- aggregation over the ranks ----------------------------------------------

  def _sum(self, values) -> List[float]:
    """Each value (a tensor on the device or a number) summed over the
    ranks in float64: one all-reduce, one read-back."""
    t = torch.stack([torch.as_tensor(v, dtype=torch.float64,
                                     device=self.device).reshape(())
                     for v in values])
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
    return t.tolist()

  def total_frames(self, state: EngineState) -> int:
    """Env frames of all ranks' streams."""
    return int(self._sum([state.env_frames])[0])

  def eval_metrics(self, estate: EvalState) -> dict:
    """Eval sums over the ranks: env frames, episodes and their mean
    return. The float sums are rounded to float32, as JAX's psums of
    float32 leaves are (equal at two ranks)."""
    frames, eps, rets = self._sum([estate.env_frames, estate.completed_count,
                                   estate.completed_return_sum])
    episodes = float(np.float32(eps))
    return {
        "env_frames": int(frames),
        "episodes": episodes,
        "mean_episode_return": (float(np.float32(rets)) / episodes
                                if episodes else math.nan),
    }

  def metrics(self, state: EngineState) -> dict:
    """Training metrics over the ranks, as the JAX trainer's psums give
    them: sums of frames, episodes, returns, learn steps and the value
    EWMA; with no episode completed the mean in-progress return of all
    ranks' streams (the reference's EpisodeTracker fallback); ε the mean of
    the ranks' (each from its own frame count)."""
    tel = state.telemetry
    f32 = np.float32
    (frames, count, rets, learns, ewma, trace, in_prog, streams,
     eps) = self._sum([
         state.env_frames, tel.completed_count, tel.completed_return_sum,
         tel.learn_steps, tel.state_value_ewma, tel.ewma_trace,
         tel.episode_return.sum(), tel.episode_return.shape[0],
         self.engine.exploration_epsilon(state.env_frames)])
    episodes = float(f32(count))
    trace = f32(trace)
    return {
        "env_frames": int(frames),
        "episodes": episodes,
        "mean_episode_return": (float(f32(rets)) / episodes if episodes
                                else float(f32(in_prog) / f32(streams))),
        "learn_steps": int(learns),
        "state_value_ewma": (float(f32(ewma)) / float(trace) if trace > 0
                             else math.nan),
        "exploration_epsilon": float(f32(eps) / f32(self.world_size)),
    }

  def reset_telemetry(self, state: EngineState) -> EngineState:
    """The per-phase reset, on this rank's telemetry (no collective)."""
    return self.engine.reset_telemetry(state)

  def agree(self, flag: bool) -> bool:
    """The group's first rank's `flag`, on every rank (one broadcast).
    Every decision that ends a loop is taken there, so that no rank leaves
    a collective that another rank is still in."""
    t = torch.tensor([int(flag)], dtype=torch.int32, device=self.device)
    dist.broadcast(t, src=self._src, group=self.group)
    return bool(t.item())
