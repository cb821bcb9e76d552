"""Host-side Atari preprocessing (port of dqn_zoo_tpu/processors.py).

The reference's processor pipeline (processors.py:421-508) as one stateful
class: action repeat 4 with None-signalled repeats, life-loss discount
zeroing on MID steps, max-pool of the last two frames with episode-boundary
zero padding, luma, Pillow's bilinear 84×84, reward sum and clip, discount
product × 0.99, frame stack 4 with trailing zero frames.

Two replacements keep the port free of dm_env and Pillow: timesteps are the
port's `envs.timestep` (read only through their fields and `first()`,
`mid()` and `last()`, so a dm_env.TimeStep works as well), and the resize
is the exact Pillow resize `prep.pil_resize.resize_pil_exact`, run on the
CPU in float64. The luma is NumPy's float64 `tensordot` and a truncating
`astype(np.uint8)`, as in the JAX package, so an observation is the JAX
package's bit for bit.
"""

from __future__ import annotations

import collections
from typing import Optional, Tuple

import numpy as np
import torch

from dqn_zoo_torch.envs import timestep as ts_lib
from dqn_zoo_torch.prep.pil_resize import resize_pil_exact


def reset(processor) -> None:
  """Resets a processor if it has a reset method (ref processors.py:54-57)."""
  r = getattr(processor, "reset", None)
  if callable(r):
    r()


def _resize(image: np.ndarray, shape: Tuple[int, int]) -> np.ndarray:
  """Pillow's BILINEAR resize of a (H, W) or (H, W, C) uint8 image to
  `shape` (h, w); each channel of a colour image as Pillow resamples it."""
  x = torch.from_numpy(np.ascontiguousarray(image))
  if x.dim() == 3:
    return resize_pil_exact(x.permute(2, 0, 1), shape).permute(
        1, 2, 0).contiguous().numpy()
  return resize_pil_exact(x, shape).numpy()


class AtariProcessor:
  """timestep -> Optional[timestep] with the reference's DQN preprocessing."""

  def __init__(self,
               additional_discount: float = 0.99,
               max_abs_reward: Optional[float] = 1.0,
               resize_shape: Tuple[int, int] = (84, 84),
               num_action_repeats: int = 4,
               num_pooled_frames: int = 2,
               zero_discount_on_life_loss: bool = True,
               num_stacked_frames: int = 4,
               grayscaling: bool = True):
    self._additional_discount = additional_discount
    self._max_abs_reward = max_abs_reward
    self._resize_shape = resize_shape
    self._repeat = num_action_repeats
    self._pool = num_pooled_frames
    self._life_loss = zero_discount_on_life_loss
    self._stack_n = num_stacked_frames
    self._gray = grayscaling
    self.reset()

  def reset(self) -> None:
    self._group = []  # buffered raw timesteps since last emit
    self._steps_since_first = None
    self._stack = collections.deque(maxlen=self._stack_n)
    self._prev_lives = None

  def _frame_to_obs(self, frames) -> np.ndarray:
    """max-pool last `pool` frames (zero-padded) → gray → resize."""
    pool = frames[-self._pool:]
    while len(pool) < self._pool:
      pool = [np.zeros_like(pool[0])] + pool
    pooled = np.max(np.stack(pool, 0), axis=0)
    if self._gray:
      pooled = np.tensordot(
          pooled, [0.299, 0.587, 1 - (0.299 + 0.587)], (-1, 0)
      ).astype(np.uint8)
    if self._resize_shape:
      pooled = _resize(pooled, self._resize_shape)
    return pooled

  def __call__(self, timestep) -> Optional[ts_lib.TimeStep]:
    rgb, lives = timestep.observation

    # ZeroDiscountOnLifeLoss (processors.py:274-293): MID steps only.
    if self._life_loss:
      life_lost = timestep.mid() and self._prev_lives is not None \
          and lives < self._prev_lives
      self._prev_lives = lives
      if life_lost:
        timestep = timestep._replace(discount=0.0)

    if timestep.first():
      self.reset()
      self._prev_lives = lives
      self._steps_since_first = 0
      self._group = [timestep._replace(observation=rgb)]
      # FIRST group is zero-padded at the front: only this frame pools.
      group_frames = [np.zeros_like(rgb), rgb][-self._pool:]
      out_step_type = ts_lib.StepType.FIRST
    else:
      self._steps_since_first += 1
      self._group.append(timestep._replace(observation=rgb))
      is_last = timestep.last()
      periodic = (self._steps_since_first % self._repeat) == 0
      if not (is_last or periodic):
        return None
      frames = [t.observation for t in self._group]
      # zero-pad after LAST up to the repeat length (processors.py:446-452)
      while len(frames) < self._repeat:
        frames.append(np.zeros_like(frames[0]))
      group_frames = frames[-self._pool:]
      out_step_type = (ts_lib.StepType.LAST if is_last
                       else ts_lib.StepType.MID)

    obs = self._frame_to_obs(group_frames)
    self._stack.append(obs)
    stacked = list(self._stack)
    while len(stacked) < self._stack_n:
      stacked.append(np.zeros_like(obs))
    observation = np.stack(stacked, axis=-1)

    if out_step_type == ts_lib.StepType.FIRST:
      reward = None
      discount = None
    else:
      reward = sum(t.reward for t in self._group)
      if self._max_abs_reward is not None:
        reward = max(min(reward, self._max_abs_reward),
                     -self._max_abs_reward)
      discount = 1.0
      for t in self._group:
        discount *= t.discount
      discount *= self._additional_discount

    self._group = []
    return ts_lib.TimeStep(step_type=out_step_type, reward=reward,
                           discount=discount, observation=observation)


def atari(**kwargs) -> AtariProcessor:
  """Factory matching the reference's processors.atari() signature."""
  return AtariProcessor(**kwargs)


class AtariEnvironmentWrapper:
  """Env-side preprocessing variant (ref processors.py:511-596): the wrapper
  owns the processor and the RL loop sees preprocessed timesteps directly;
  action repeat happens inside step(). It has dm_env.Environment's
  methods; the wrapped environment may be a dm_env one or the port's."""

  def __init__(self, environment, **processor_kwargs):
    self._environment = environment
    self._processor = AtariProcessor(**processor_kwargs)

  def reset(self) -> ts_lib.TimeStep:
    self._processor.reset()
    processed = self._processor(self._environment.reset())
    if processed is None:
      raise RuntimeError("the processor emitted nothing for a FIRST step.")
    return processed

  def step(self, action) -> ts_lib.TimeStep:
    while True:
      processed = self._processor(self._environment.step(action))
      if processed is not None:
        return processed

  def observation_spec(self) -> ts_lib.Array:
    h, w = self._processor._resize_shape
    return ts_lib.Array(shape=(h, w, self._processor._stack_n),
                        dtype=np.uint8, name="stacked_grayscale")

  def action_spec(self):
    return self._environment.action_spec()
