"""The reference's run of the first three learning steps of a cell.

It starts from what the benchmark made (the weights, the fill rows through
the traffic's seed, the draws of the three supersteps) and from the env's
raw output (the two last frames of each agent step, its rewards, discounts
and episode flags: the env is the one stage it does not redo), and works out
the rest itself: the frames, the stacks the actor sees, the rows each
superstep writes, the active rows and their priorities, each sampled
transition, the loss, the gradients and Adam's updates. The program's
actions and sampled leaves are taken as given, to follow the same rows, and
judged: each action against the reference's Q-values, each leaf against the
reference's replay.
"""

from __future__ import annotations

import importlib
import math
from typing import Dict, List, Optional

import torch

from benchmark.reference import common
from benchmark.reference.replay import ReplayModel
from benchmark.traffic import FillRows

FAULTS = (None, "half_batch", "unchanged", "altered_action", "altered_leaf",
          "altered_row")


def family(name: str):
  return importlib.import_module(f"benchmark.reference.{name}")


def hyper(flags: dict, num_envs: int, slots: int, batch: int,
          traffic: dict) -> dict:
  """The schedules' and the optimizer's numbers of the config's flags,
  with throughput mode's learning rate × √(batch / agent batch)."""
  capacity = num_envs * slots
  total = traffic["num_iterations"] * traffic["num_train_frames"]
  return dict(
      lr=flags["learning_rate"] * math.sqrt(batch / flags["batch_size"]),
      eps=flags["optimizer_epsilon"],
      max_norm=flags.get("max_global_grad_norm", 0.0),
      act_eps=dict(begin_value=flags["exploration_epsilon_begin_value"],
                   end_value=flags["exploration_epsilon_end_value"],
                   begin_t=flags["min_replay_capacity_fraction"] * capacity
                   * 4,
                   end_t=flags["min_replay_capacity_fraction"] * capacity * 4
                   + flags["exploration_epsilon_decay_frame_fraction"]
                   * total),
      beta=dict(begin_value=flags.get(
          "importance_sampling_exponent_begin_value", 0.0),
                end_value=flags.get(
                    "importance_sampling_exponent_end_value", 0.0),
                begin_t=flags["min_replay_capacity_fraction"] * capacity,
                end_t=total // 4))


def _stack(obs: List[torch.Tensor], first: List[torch.Tensor],
           i: int) -> torch.Tensor:
  """The actor's (S, 84, 84, 4) stack after output i: that output's frame
  and those before it back to its episode's first, at most four, oldest
  first, zero-padded after."""
  count = _count(first, i)
  s = obs[i].shape[0]
  out = torch.zeros((s, 84, 84, 4), dtype=torch.uint8, device=obs[i].device)
  for c in range(4):
    # channel c holds output i - count + 1 + c where c < count
    for n in range(1, 5):
      rows = (count == n) & (c < n)
      if bool(rows.any()):
        out[rows, :, :, c] = obs[i - n + 1 + c][rows]
  return out


def _count(first: List[torch.Tensor], i: int) -> torch.Tensor:
  """Frames in the stack after output i: up to 4, back to a first output."""
  count = torch.full(first[i].shape, 4, dtype=torch.int64,
                     device=first[i].device)
  for back in range(3, -1, -1):
    count = torch.where(first[i - back], back + 1, count)
  return count


def _row(out: dict, obs: torch.Tensor, count: torch.Tensor,
         action: torch.Tensor) -> Dict[str, torch.Tensor]:
  """The replay row of an env output: rewards clipped to [-1, 1], the
  discount × 0.99, both 0 on an episode's first row."""
  first = out["is_first"]
  zero = torch.zeros_like(out["reward_sum"])
  return dict(frame=obs, stack_count=count.to(torch.int32),
              action=action.to(torch.int32),
              reward=torch.where(first, zero,
                                 torch.clamp(out["reward_sum"], -1.0, 1.0)),
              discount=torch.where(first, zero, out["discount_prod"] * 0.99),
              is_terminal=out["is_last"])


def follow(inp: dict, precision: str = "f32",
           fault: Optional[str] = None) -> dict:
  """Three supersteps' learning as the reference computes it; see the module
  docstring. `inp` is what the harness hands over (benchmark/harness.py,
  `Handover`); `fault` plants one of FAULTS in the reference, for the
  comparison's calibration."""
  if precision not in common.PRECISIONS or fault not in FAULTS:
    raise ValueError(f"precision {precision!r}, fault {fault!r}")
  common.strict_f32()
  fam = family(inp["reference"])
  flags, traffic = inp["flags"], inp["traffic"]
  a = inp["num_actions"]
  hp = hyper(flags, inp["num_envs"], inp["slots"], inp["batch_size"],
             traffic)
  dev = inp["outputs"][0]["is_first"].device
  fill = FillRows(inp["seed"], traffic, a)
  replay = ReplayModel(
      fill, inp["num_envs"], inp["slots"], flags["n_steps"],
      inp["inserted"], dev,
      priority_exponent=flags.get("priority_exponent", 0.0),
      uniform_sample_probability=flags.get("uniform_sample_probability",
                                           0.0),
      weight_chunk=flags["batch_size"] if flags.get("normalize_weights",
                                                    True) else 0)
  online = {k: v.detach().clone().requires_grad_(True)
            for k, v in common.flat(inp["params0"]).items()}
  target = {k: v.detach().clone() for k, v in online.items()}
  adam = common.Adam(hp["lr"], hp["eps"], hp["max_norm"])

  outputs = inp["outputs"]
  obs = [common.frames_to_84(o["frame_penult"], o["frame_last"], precision)
         for o in outputs]
  first = [o["is_first"] for o in outputs]
  spread = len(outputs) - 2  # the spread's last output is outputs[spread - 1]
  # ε in f32, as the program's schedule gives it.
  eps = float(torch.tensor(common.linear_schedule(inp["env_frames"],
                                                  **hp["act_eps"]),
                           dtype=torch.float32))
  res = dict(stacks=[], q=[], own_actions=[], batches=[], sample_gap=[],
             losses=[], priorities=[], select_margin=[], eps=eps,
             params0={k: v.detach().clone() for k, v in target.items()})
  for j in range(3):
    d = inp["draws"][j]
    i = spread - 1 + j
    stack = _stack(obs, first, i)
    with torch.no_grad():
      q = fam.act_q(_unflat(online), stack, d, flags, a, precision)
    own = torch.where(d["explore_u"] < eps, d["random_action"].long(),
                      q.argmax(-1))
    if fault == "altered_action" and j == 0:
      own = own.clone()
      own[0] = (own[0] + 1) % a
    res["stacks"].append(stack)
    res["q"].append(q)
    res["own_actions"].append(own)
    replay.write(_row(outputs[i], obs[i], _count(first, i),
                      inp["actions"][j]))
    leaves = inp["leaves"][j]
    if fault == "altered_leaf" and j == 0:
      leaves = leaves.clone()
      leaves[0] = (leaves[0] + leaves.max() // 2 + 1) % (inp["num_envs"]
                                                         * inp["slots"])
    res["sample_gap"].append(replay.sample_gap(leaves, d["sample_u"]))
    beta = common.linear_schedule(replay.t * inp["num_envs"], **hp["beta"])
    batch, weights = replay.batch(leaves, beta)
    if fault == "altered_row" and j == 0:
      altered = batch.s_tm1.clone()
      altered[0, 0, 0, 0] ^= 1
      res["batches"].append(batch._replace(s_tm1=altered))
    else:
      res["batches"].append(batch)
    mean, _, prio, margin = fam.loss(_unflat(online), _unflat(target), batch,
                                     weights, d, flags, a, precision,
                                     half_batch=fault == "half_batch")
    res["select_margin"].append(margin)
    names = sorted(online)
    grads = torch.autograd.grad(mean, [online[k] for k in names])
    if fault == "unchanged":
      used = [torch.zeros_like(g) for g in grads]
    else:
      used = adam.step([online[k] for k in names], list(grads))
    if j == 0:
      res["grad1"] = {k: g.detach().clone() for k, g in zip(names, used)}
    res["losses"].append(float(mean.detach()))
    res["priorities"].append(prio)
    if replay.alpha > 0:
      replay.write_priorities(leaves, prio)
  res["params3"] = {k: v.detach().clone() for k, v in online.items()}
  return res


def _unflat(flat: Dict[str, torch.Tensor]) -> dict:
  tree: dict = {}
  for path, v in flat.items():
    node = tree
    *head, last = path.split("/")
    for k in head:
      node = node.setdefault(k, {})
    node[last] = v
  return tree
