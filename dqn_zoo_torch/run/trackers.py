"""Host-side run telemetry (port of dqn_zoo_tpu/run/trackers.py)."""

from __future__ import annotations

import timeit
from typing import Any, Mapping, Optional


class StepRateTracker:
  """Wall-clock frames/sec within a phase."""

  def __init__(self):
    self.reset()

  def reset(self) -> None:
    self._start: Optional[float] = None
    self._frames = 0

  def update(self, frames: int) -> None:
    if self._start is None:
      self._start = timeit.default_timer()
    self._frames += frames

  def get(self) -> Mapping[str, Any]:
    if self._start is None:
      return {"step_rate": float("nan"), "duration": 0.0}
    dur = timeit.default_timer() - self._start
    return {
        "step_rate": self._frames / dur if dur > 0 else float("nan"),
        "duration": dur,
    }
