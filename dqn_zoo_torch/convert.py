"""Carry weights and state across from the JAX package.

Every function takes the JAX object already fetched to the host (numpy
arrays inside the same pytree containers: dicts, tuples and NamedTuples,
read by attribute name) and returns the port's counterpart on `device`.
Nothing here imports JAX.

Layouts: parameters keep the JAX layout leaf for leaf. Conv weights stay
HWIO (kh, kw, in, out), which is what kernel K3 reads; only the plain torso
version (nets/core.conv2d) and the torso backward turn them into OIHW, on
the fly, with `hwio_to_oihw`. Dense weights stay (in, out). The torso
flattens in (y, x, c) order like JAX, so `head.hidden.w` needs no row
permutation.
"""

from __future__ import annotations

import types
from typing import Any, Union

import numpy as np
import torch

from dqn_zoo_torch.agents.base import AdamState, RMSPropState
from dqn_zoo_torch.engine.host_env import HostEngineState, HostEnvEngine
from dqn_zoo_torch.engine.superstep import (Engine, EngineState, PendingRow,
                                            Telemetry)
from dqn_zoo_torch.envs.vector import VecEnvState
from dqn_zoo_torch.prep.atari import FrameStackState
from dqn_zoo_torch.replay.device_replay import ReplayState
from dqn_zoo_torch.utils.pytree import leaves


def tensor(x, device) -> torch.Tensor:
  return torch.from_numpy(np.array(x, copy=True)).to(device)


def params_from_jax(tree, device, requires_grad: bool = False):
  """{"torso": {"conv1": {"w", "b"}, ...}, "head": {...}} (and IQN's
  "tau_embed": {"w", "b"}, rainbow's noisy {"mu", "sigma"} layers) of numpy
  arrays → the same nesting of tensors; an empty dict (a JAX ReLU layer's)
  stays empty and holds no leaf."""
  if isinstance(tree, dict):
    return {k: params_from_jax(v, device, requires_grad)
            for k, v in tree.items()}
  return tensor(tree, device).requires_grad_(requires_grad)


def _find_moments(opt_state) -> Any:
  """The state of an optax chain that holds `mu` and `nu` parameter trees
  (inside `optax.chain(clip_by_global_norm, adam)`'s tuple, past the clip's
  empty state)."""
  if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
    return opt_state
  if isinstance(opt_state, (tuple, list)):
    for s in opt_state:
      found = _find_moments(s)
      if found is not None:
        return found
  return None


def opt_state_from_jax(opt_state, device) -> Union[RMSPropState, AdamState]:
  """optax optimizer state → the port's, with leaves in sorted-key order.

  Both optimizers the agents use keep `mu` and `nu`: centered RMSProp's
  ScaleByRStdDevState has nothing else, Adam's ScaleByAdamState also has
  the step `count` that its bias correction needs. So a state with `count`
  is Adam's and comes back as AdamState (the count on the host), one
  without is RMSProp's."""
  found = _find_moments(opt_state)
  if found is None:
    raise ValueError("no (mu, nu) optimizer state in opt_state.")
  mu = leaves(params_from_jax(found.mu, device))
  nu = leaves(params_from_jax(found.nu, device))
  # Not hasattr: both states are tuples, and every tuple has a `count` method.
  if "count" in getattr(found, "_fields", ()):
    return AdamState(count=torch.tensor(int(found.count), dtype=torch.int64),
                     mu=mu, nu=nu)
  return RMSPropState(mu=mu, nu=nu)


def namedtuple_from_jax(cls, src, device):
  """`cls` built from `src`'s fields of the same names (extra JAX fields,
  such as PRNG keys, are dropped)."""
  return cls(*(tensor(getattr(src, f), device) for f in cls._fields))


def env_state_from_jax(engine: Engine, env_state, device) -> VecEnvState:
  """JAX VecEnvState → port VecEnvState; game and wrapper keys dropped."""
  game_cls = type(engine.game.init(engine.game.init_draws(
      torch.Generator(), 1, "cpu")))
  return VecEnvState(
      game_state=namedtuple_from_jax(game_cls, env_state.game_state, device),
      episode_frames=tensor(env_state.episode_frames, device),
      needs_reset=tensor(env_state.needs_reset, device))


def replay_from_jax(replay, frame_size: int, device,
                    prioritized: bool = False) -> ReplayState:
  """JAX ReplayState → port ReplayState. Frame rows lose the TPU padding:
  (S, C+W, 64, 128) → (S, C+W, 84, 84). Uniform replay (`prioritized`
  false) keeps one tree, whose values JAX's two trees must share."""
  frames = np.asarray(replay.frames)
  s, r = frames.shape[:2]
  flat = frames.reshape(s, r, -1)[..., :frame_size * frame_size]
  ind = [tensor(x, device) for x in replay.indicator_tree]
  if prioritized:
    value = [tensor(x, device) for x in replay.value_tree]
  elif all(np.array_equal(a, b) for a, b in zip(replay.value_tree,
                                                  replay.indicator_tree)):
    value = ind
  else:
    raise ValueError("a uniform replay state whose value tree differs from "
                     "its indicator tree; pass prioritized=True.")
  return ReplayState(
      frames=tensor(flat.reshape(s, r, frame_size, frame_size), device),
      stack_count=tensor(replay.stack_count, device),
      action=tensor(replay.action, device),
      reward=tensor(replay.reward, device),
      discount=tensor(replay.discount, device),
      is_terminal=tensor(replay.is_terminal, device),
      row_t=tensor(replay.row_t, device),
      value_tree=value,
      indicator_tree=ind,
      t=int(replay.t),
      max_seen_priority=tensor(replay.max_seen_priority, device),
  )


def _learner_fields(engine: Union[Engine, HostEnvEngine], state, seed: int
                   ) -> dict:
  """The fields a JAX EngineState and HostEngineState share, on the
  engine's device (a fresh generator from `seed` replaces the JAX key)."""
  dev = engine.device
  tel = state.telemetry
  gen = torch.Generator(device=dev)
  gen.manual_seed(seed)
  return dict(
      stack=namedtuple_from_jax(FrameStackState, state.stack, dev),
      replay=replay_from_jax(state.replay, engine.rcfg.frame_size, dev,
                             engine.rcfg.priority_exponent > 0),
      online_params=params_from_jax(state.online_params, dev,
                                    requires_grad=True),
      target_params=params_from_jax(state.target_params, dev),
      opt_state=opt_state_from_jax(state.opt_state, dev),
      generator=gen,
      env_frames=int(state.env_frames),
      superstep=int(state.superstep),
      telemetry=Telemetry(
          *(tensor(getattr(tel, f), dev) for f in Telemetry._fields[:-1]),
          learn_steps=int(tel.learn_steps)))


def engine_state_from_jax(engine: Engine, state, seed: int = 0
                          ) -> EngineState:
  """A whole JAX EngineState → port EngineState (a fresh generator from
  `seed` replaces the JAX key)."""
  dev = engine.device
  return EngineState(
      env=env_state_from_jax(engine, state.env, dev),
      pending=namedtuple_from_jax(PendingRow, state.pending, dev),
      **_learner_fields(engine, state, seed))


def device_slice(tree, rank: int):
  """Device `rank`'s slice of a nest whose every leaf has a leading device
  axis (JAX's `DistState.per_device`), in the same containers."""
  if hasattr(tree, "_fields"):
    return type(tree)(*(device_slice(x, rank) for x in tree))
  if isinstance(tree, dict):
    return {k: device_slice(v, rank) for k, v in tree.items()}
  if isinstance(tree, (list, tuple)):
    return type(tree)(device_slice(x, rank) for x in tree)
  return np.asarray(tree)[rank]


def dist_state_from_jax(trainer, jax_dstate, rank: int, seed: int = 0
                        ) -> EngineState:
  """Rank `rank`'s EngineState from a JAX DistState (fetched to the host):
  device `rank`'s slice of `per_device` joined with the replicated nets,
  on `trainer.engine`'s device (a fresh generator from `seed` replaces the
  JAX key)."""
  per = device_slice(jax_dstate.per_device, rank)
  return engine_state_from_jax(trainer.engine, types.SimpleNamespace(
      **per._asdict(), online_params=jax_dstate.online_params,
      target_params=jax_dstate.target_params,
      opt_state=jax_dstate.opt_state), seed)


def host_engine_state_from_jax(engine: HostEnvEngine, state, seed: int = 0
                               ) -> HostEngineState:
  """A JAX HostEngineState → port HostEngineState (a fresh generator from
  `seed` replaces the JAX key)."""
  return HostEngineState(**_learner_fields(engine, state, seed))


def _replay_state_from_jax(state):
  """A JAX host replay's state with every stored transition re-made as the
  port's `replay.host.Transition` (a NamedTuple of the same fields); the
  rest (ids, trees' values, free lists) is NumPy and plain values, as is."""
  from dqn_zoo_torch.replay.host import Transition
  storage = state["storage"]
  items = [(i, Transition(*item) if hasattr(item, "_fields") else item)
           for i, item in storage["items"]]
  return {**state, "storage": {**storage, "items": items}}


def host_agent_state_from_jax(agent, jax_state, device) -> dict:
  """A JAX `HostAgent.get_state()` (fetched to the host) → the state the
  port's `HostAgent.set_state` takes, tensors on `device`.

  The parameters and the optimizer state go through `params_from_jax` and
  `opt_state_from_jax`; the replay's state and the NumPy `random_state`
  pass through as NumPy. JAX's threefry `rng_key` has no counterpart: the
  port's generator keeps its own state (`agent`'s, as it stands)."""
  return {
      "generator": agent._generator.get_state(),
      "frame_t": int(jax_state["frame_t"]),
      "opt_state": opt_state_from_jax(jax_state["opt_state"], device),
      "online_params": params_from_jax(jax_state["online_params"], device,
                                       requires_grad=True),
      "target_params": params_from_jax(jax_state["target_params"], device),
      "replay": _replay_state_from_jax(jax_state["replay"]),
      "max_seen_priority": float(jax_state["max_seen_priority"]),
      "random_state": jax_state["random_state"],
  }
