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

from typing import Any, Union

import numpy as np
import torch

from dqn_zoo_torch.agents.base import AdamState, RMSPropState
from dqn_zoo_torch.engine.superstep import (Engine, EngineState, PendingRow,
                                            Telemetry, leaves)
from dqn_zoo_torch.envs.vector import VecEnvState
from dqn_zoo_torch.prep.atari import FrameStackState
from dqn_zoo_torch.replay.device_replay import ReplayState


def tensor(x, device) -> torch.Tensor:
  return torch.from_numpy(np.array(x, copy=True)).to(device)


def params_from_jax(tree, device, requires_grad: bool = False):
  """{"torso": {"conv1": {"w", "b"}, ...}, "head": {...}} (and IQN's
  "tau_embed": {"w", "b"}) of numpy arrays → the same nesting of tensors."""
  if isinstance(tree, dict):
    return {k: params_from_jax(v, device, requires_grad)
            for k, v in tree.items()}
  return tensor(tree, device).requires_grad_(requires_grad)


def _find_moments(opt_state) -> Any:
  """The state of an optax chain that holds `mu` and `nu` parameter trees."""
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


def replay_from_jax(replay, frame_size: int, device) -> ReplayState:
  """JAX ReplayState → port ReplayState. Frame rows lose the TPU padding:
  (S, C+W, 64, 128) → (S, C+W, 84, 84)."""
  frames = np.asarray(replay.frames)
  s, r = frames.shape[:2]
  flat = frames.reshape(s, r, -1)[..., :frame_size * frame_size]
  ind = [tensor(x, device) for x in replay.indicator_tree]
  same = all(np.array_equal(a, b) for a, b in zip(replay.value_tree,
                                                  replay.indicator_tree))
  if not same:
    raise NotImplementedError("prioritized replay state is not ported yet.")
  return ReplayState(
      frames=tensor(flat.reshape(s, r, frame_size, frame_size), device),
      stack_count=tensor(replay.stack_count, device),
      action=tensor(replay.action, device),
      reward=tensor(replay.reward, device),
      discount=tensor(replay.discount, device),
      is_terminal=tensor(replay.is_terminal, device),
      row_t=tensor(replay.row_t, device),
      indicator_tree=ind,
      t=int(replay.t),
  )


def engine_state_from_jax(engine: Engine, state, seed: int = 0
                          ) -> EngineState:
  """A whole JAX EngineState → port EngineState (a fresh generator from
  `seed` replaces the JAX key)."""
  dev = engine.device
  tel = state.telemetry
  gen = torch.Generator(device=dev)
  gen.manual_seed(seed)
  return EngineState(
      env=env_state_from_jax(engine, state.env, dev),
      stack=namedtuple_from_jax(FrameStackState, state.stack, dev),
      pending=namedtuple_from_jax(PendingRow, state.pending, dev),
      replay=replay_from_jax(state.replay, engine.rcfg.frame_size, dev),
      online_params=params_from_jax(state.online_params, dev,
                                    requires_grad=True),
      target_params=params_from_jax(state.target_params, dev),
      opt_state=opt_state_from_jax(state.opt_state, dev),
      generator=gen,
      env_frames=int(state.env_frames),
      superstep=int(state.superstep),
      telemetry=Telemetry(
          *(tensor(getattr(tel, f), dev) for f in Telemetry._fields[:-1]),
          learn_steps=int(tel.learn_steps)),
  )
