"""Linear schedules (port of dqn_zoo_tpu/utils/schedules.py)."""

from __future__ import annotations

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
