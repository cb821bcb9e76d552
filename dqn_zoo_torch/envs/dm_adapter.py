"""A dm_env-style environment over one env of the port's batched Game (port
of dqn_zoo_tpu/envs/dm_adapter.py's JaxGameEnvironment).

Observations are `(rgb (210, 160, 3) uint8 NumPy, lives int32)` tuples;
each episode starts with 1..max_noops noop frames (a RuntimeError if the
episode ends during them, as the reference's gym_atari.py:198-205 raises);
FIRST is explicit, raw frames are not skipped, and `step` after LAST
resets. The game runs at B = 1 on the resolved device, and each frame's
render is read back to the host: this is the single-stream compatibility
path; the vector env and the engines are the throughput path.

Randomness is an input. The game's init draws, each raw frame's step draws
and the noop count come from `draws`, by default `GeneratorDraws` over the
adapter's generator (seeded from `seed`); a test hands in a source that
gives the values the JAX package draws.
"""

from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch

from dqn_zoo_torch.device import resolve_device
from dqn_zoo_torch.envs import timestep as ts_lib
from dqn_zoo_torch.envs.api import FRAME_HEIGHT, FRAME_WIDTH, Game, get_game


class GeneratorDraws:
  """The adapter's draws from a `torch.Generator` on its device.

  reset() -> (the game's init draws for B = 1, the noop count in
  [1, max_noops]); step(action) -> the step draws of one raw frame (the
  action is not used; a source that mirrors another environment may need
  it)."""

  def __init__(self, game: Game, generator: torch.Generator,
               max_noops: int, device: torch.device):
    self._game = game
    self._gen = generator
    self._max_noops = max_noops
    self._device = device

  def reset(self) -> Tuple[Any, int]:
    init = self._game.init_draws(self._gen, 1, self._device)
    noops = 0
    if self._max_noops > 0:
      noops = int(torch.randint(1, self._max_noops + 1, (1,),
                                generator=self._gen, device=self._device))
    return init, noops

  def step(self, action: int):
    del action
    if self._game.per_frame_draws:
      d = self._game.step_draws(self._gen, 1, self._device, 1)
      return type(d)(*(x[0] for x in d))
    return self._game.step_draws(self._gen, 1, self._device)


class GameEnvironment:
  """Single-instance dm_env-style view of a Game, one RAW frame a step."""

  def __init__(self, game: Game | str, seed: int = 0, max_noops: int = 30,
               noop_action: int = 0, device=None, draws=None):
    self._game = get_game(game) if isinstance(game, str) else game
    self.device = resolve_device(device)
    self._max_noops = max_noops
    self._noop_action = torch.tensor([noop_action], device=self.device)
    if draws is None:
      gen = torch.Generator(device=self.device)
      gen.manual_seed(seed)
      draws = GeneratorDraws(self._game, gen, max_noops, self.device)
    self.draws = draws
    self._state = None
    self._start_of_episode = True

  def _observation(self):
    rgb = self._game.render(self._state)[0].cpu().numpy()
    lives = np.int32(int(self._game.lives(self._state)[0]))
    return (rgb, lives)

  def _frame(self, action: torch.Tensor, action_int: int):
    self._state, reward, done, _ = self._game.step(
        self._state, action, self.draws.step(action_int))
    return reward, done

  def reset(self) -> ts_lib.TimeStep:
    init, noops = self.draws.reset()
    self._state = self._game.init(init)
    for _ in range(noops):
      _, done = self._frame(self._noop_action, int(self._noop_action[0]))
      if bool(done[0]):
        raise RuntimeError("Episode ended during noop starts "
                           "(ref gym_atari.py:198-205 raises too).")
    self._start_of_episode = False
    return ts_lib.restart(self._observation())

  def step(self, action) -> ts_lib.TimeStep:
    if self._state is None or self._start_of_episode:
      return self.reset()
    reward, done = self._frame(
        torch.tensor([int(action)], device=self.device), int(action))
    # The life loss is exposed through the lives observation, as in the
    # reference.
    obs = self._observation()
    if bool(done[0]):
      self._start_of_episode = True
      return ts_lib.termination(float(reward[0]), obs)
    return ts_lib.transition(float(reward[0]), obs)

  def observation_spec(self):
    return (
        ts_lib.Array(shape=(FRAME_HEIGHT, FRAME_WIDTH, 3), dtype=np.uint8,
                     name="rgb"),
        ts_lib.Array(shape=(), dtype=np.int32, name="lives"),
    )

  def action_spec(self) -> ts_lib.DiscreteArray:
    return ts_lib.DiscreteArray(num_values=self._game.num_actions,
                                dtype=np.int32, name="action")
