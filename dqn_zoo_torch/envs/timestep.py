"""Timesteps and specs with dm_env's interface (dm_env/_environment.py and
dm_env/specs.py), so that the port needs no dm_env.

`StepType`, `TimeStep` with `first()`, `mid()` and `last()`, and `restart`,
`transition`, `termination` and `truncation` are dm_env's field for field.
The port's `parts` and `processors` read a timestep only through its fields
and these methods, so a real `dm_env.Environment` drives them unchanged:
dm_env's StepType is an IntEnum with the same values, and the two compare
equal.
"""

from __future__ import annotations

import enum
from typing import Any, NamedTuple, Optional, Tuple

import numpy as np


class StepType(enum.IntEnum):
  """Where a timestep lies in its sequence."""

  FIRST = 0
  MID = 1
  LAST = 2

  def first(self) -> bool:
    return self is StepType.FIRST

  def mid(self) -> bool:
    return self is StepType.MID

  def last(self) -> bool:
    return self is StepType.LAST


class TimeStep(NamedTuple):
  """step_type, reward and discount (None at FIRST), observation."""

  step_type: Any
  reward: Any
  discount: Any
  observation: Any

  def first(self) -> bool:
    return self.step_type == StepType.FIRST

  def mid(self) -> bool:
    return self.step_type == StepType.MID

  def last(self) -> bool:
    return self.step_type == StepType.LAST


def restart(observation) -> TimeStep:
  return TimeStep(StepType.FIRST, None, None, observation)


def transition(reward, observation, discount=1.0) -> TimeStep:
  return TimeStep(StepType.MID, reward, discount, observation)


def termination(reward, observation) -> TimeStep:
  return TimeStep(StepType.LAST, reward, 0.0, observation)


def truncation(reward, observation, discount=1.0) -> TimeStep:
  return TimeStep(StepType.LAST, reward, discount, observation)


class Array(NamedTuple):
  """dm_env.specs.Array's shape, dtype and name."""

  shape: Tuple[int, ...]
  dtype: Any
  name: Optional[str] = None


class DiscreteArray(NamedTuple):
  """dm_env.specs.DiscreteArray: a scalar integer in [0, num_values)."""

  num_values: int
  dtype: Any = np.int32
  name: Optional[str] = None

  @property
  def shape(self) -> Tuple[int, ...]:
    return ()
