"""Linear schedules (port of dqn_zoo_tpu/utils/schedules.py)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


def linear_schedule(t, *, begin_value, end_value, begin_t, end_t):
  """Linear interpolation begin_value→end_value over [begin_t, end_t), f32.

  `t` may be a number or a tensor; the result is a float32 tensor on t's
  device (the CPU for a number). Clamps outside the range.
  """
  t = torch.as_tensor(t, dtype=torch.float32)
  span = float(end_t - begin_t)
  frac = torch.clamp((t - float(begin_t)) / span, 0.0, 1.0)
  return (1.0 - frac) * begin_value + frac * end_value


@dataclasses.dataclass(frozen=True)
class LinearSchedule:
  """Callable schedule object mirroring the reference API: `linear_schedule`
  from `begin_t` to `end_t` (or `begin_t + decay_steps`)."""

  begin_value: float
  end_value: float
  begin_t: int
  end_t: Optional[int] = None
  decay_steps: Optional[int] = None

  def __post_init__(self):
    if (self.end_t is None) == (self.decay_steps is None):
      raise ValueError("Exactly one of end_t, decay_steps must be supplied.")

  @property
  def _end_t(self) -> int:
    return (self.end_t if self.end_t is not None
            else self.begin_t + self.decay_steps)

  def __call__(self, t) -> torch.Tensor:
    return linear_schedule(t, begin_value=self.begin_value,
                           end_value=self.end_value, begin_t=self.begin_t,
                           end_t=self._end_t)
