"""Vectorized environment API (port of dqn_zoo_tpu/envs/api.py).

A `Game` here is batched: every function takes and returns a NamedTuple of
tensors with a leading env axis B. Randomness is an input: a game names the
draws its init and its step need (`init_draws` / `step_draws` make them from
a `torch.Generator`), so a test can hand in the values the JAX reference drew.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, NamedTuple, Tuple

import torch

FRAME_HEIGHT = 210
FRAME_WIDTH = 160


class Game(NamedTuple):
  """A batched game as functions over tensors.

  init:        (init_draws) -> state                  episode-start states
  step:        (state, actions, step_draws) -> (state, reward, done,
               life_lost)                             one RAW frame each
  render:      (state) -> (B, 210, 160, 3) uint8
  lives:       (state) -> (B,) int32
  init_draws:  (generator, B, device) -> the draws `init` consumes
  step_draws:  (generator, B, device) -> the draws of `step`; where
               `per_frame_draws` is false, one set serves every raw frame
               of an action-repeat group (and every frame of a noop burn),
               so such a game must need at most one draw per env per group;
               where it is true, (generator, B, device, frames) -> the draws
               of `frames` raw frames, each tensor with a leading frame
               axis, and frame m of a group or a burn gets slice m
  per_frame_draws: the game draws on every raw frame (seaquest's diver
               spawns), so the vector env hands each frame its own slice
  """

  name: str
  num_actions: int
  init: Callable[[Any], Any]
  step: Callable[[Any, torch.Tensor, Any],
                 Tuple[Any, torch.Tensor, torch.Tensor, torch.Tensor]]
  render: Callable[[Any], torch.Tensor]
  lives: Callable[[Any], torch.Tensor]
  init_draws: Callable[..., Any]
  step_draws: Callable[..., Any]
  per_frame_draws: bool = False


class GroupOutput(NamedTuple):
  """Result of one agent-step (action-repeat group) for B envs."""

  frame_penult: torch.Tensor  # (B, 210, 160, 3) u8 — substep-3 frame or zeros
  frame_last: torch.Tensor  # (B, 210, 160, 3) u8 — substep-4 frame or zeros
  reward_sum: torch.Tensor  # (B,) f32 — sum of raw rewards in the group
  discount_prod: torch.Tensor  # (B,) f32 — ∏ substep discounts
  is_first: torch.Tensor  # (B,) bool
  is_last: torch.Tensor  # (B,) bool
  is_truncated: torch.Tensor  # (B,) bool — ended by frame cap
  raw_reward_sum: torch.Tensor  # (B,) f32 — unclipped
  frames_used: torch.Tensor  # (B,) i32 — raw frames consumed (1..4)
  lives: torch.Tensor  # (B,) i32


def tree_where(mask: torch.Tensor, a, b):
  """Per-env select over two NamedTuples of (B, ...) tensors."""
  def sel(x, y):
    m = mask.reshape(mask.shape + (1,) * (x.dim() - 1))
    return torch.where(m, x, y)
  return type(a)(*(sel(x, y) for x, y in zip(a, b)))


@functools.lru_cache(maxsize=None)
def constant(values: tuple, dtype: torch.dtype, device) -> torch.Tensor:
  """`torch.tensor(values, dtype=dtype, device=device)`, made once for each
  set of values (nested tuples), dtype and device and handed out again
  after: a copy from the host on every call waits for the device, and
  cannot be captured in a CUDA graph (envs/vector.py). Callers must not
  write into it."""
  return torch.tensor(values, dtype=dtype, device=device)


_REGISTRY = {}


def register_game(game: Game) -> Game:
  _REGISTRY[game.name] = game
  return game


def get_game(name: str) -> Game:
  from dqn_zoo_torch.envs.games import (assault, asterix,  # noqa: F401
                                        atlantis, beam_rider, bowling,
                                        boxing, breakout, catch,
                                        crazy_climber, demon_attack,
                                        enduro, fishing_derby, freeway,
                                        gopher, ice_hockey, ms_pacman,
                                        phoenix, pong, qbert, seaquest,
                                        skiing, space_invaders,
                                        star_gunner, tennis, zaxxon)
  if name not in _REGISTRY:
    from dqn_zoo_torch.run.atari_data import ATARI_GAMES
    if name in ATARI_GAMES:
      raise KeyError(
          f"{name!r} is an Atari-57 cartridge without a device "
          f"implementation; device games: {sorted(_REGISTRY)}. The full "
          "cartridge runs on the C++ farm's ALE backend through "
          "engine/host_env.py: build it with `make -C cpp ale` and set "
          "DZ_ENV_LIB=libdz_env_ale.so (or an absolute path) and "
          "DZ_ALE_ROM_DIR=<roms> (envs/cpp_bridge.py).")
    raise KeyError(f"Unknown game {name!r}; have {sorted(_REGISTRY)}.")
  return _REGISTRY[name]
