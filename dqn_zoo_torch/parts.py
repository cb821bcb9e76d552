"""Host-side agent/run-loop API (port of dqn_zoo_tpu/parts.py).

The reference's host capability surface (parts.py:42-527): the Agent ABC,
the run_loop generator with episode truncation and the extra step on LAST,
generate_statistics with ChainMap merging, the tracker set, and an
EpsilonGreedyActor whose params are set externally. Timesteps are read only
through their fields and `first()` / `last()`, so run_loop drives any
environment with dm_env.Environment's `reset()` and `step()`: the port's
envs.dm_adapter.GameEnvironment, or a real dm_env one.
"""

from __future__ import annotations

import abc
import collections
import timeit
from typing import Any, Iterable, Mapping, Optional, Tuple

import numpy as np
import torch

from dqn_zoo_torch import ops
from dqn_zoo_torch.device import resolve_device
from dqn_zoo_torch.envs.timestep import StepType, TimeStep
from dqn_zoo_torch.ops.policy import epsilon_greedy_draws
from dqn_zoo_torch.run.writers import CsvWriter, NullWriter  # noqa: F401
from dqn_zoo_torch.utils.schedules import LinearSchedule  # noqa: F401

Action = int


class Agent(abc.ABC):
  """Agent interface (ref parts.py:42-67)."""

  @abc.abstractmethod
  def step(self, timestep: TimeStep) -> Action:
    """Selects an action given a timestep, potentially learning."""

  @abc.abstractmethod
  def reset(self) -> None:
    """Resets episodic state; called at the start of every episode."""

  @abc.abstractmethod
  def get_state(self) -> Mapping[str, Any]:
    ...

  @abc.abstractmethod
  def set_state(self, state: Mapping[str, Any]) -> None:
    ...

  @property
  @abc.abstractmethod
  def statistics(self) -> Mapping[str, float]:
    ...


def run_loop(agent: Agent, environment, max_steps_per_episode: int = 0,
             yield_before_reset: bool = False
             ) -> Iterable[Tuple[Any, Optional[TimeStep], Agent,
                                 Optional[Action]]]:
  """Infinite generator alternating agent and environment steps.

  Reference semantics (parts.py:70-122): episode truncation rewrites the
  step type to LAST at max_steps_per_episode; the agent takes one extra
  step on LAST (so the terminal transition is learned from) whose action is
  discarded; optional yield before each reset for per-episode hooks.
  """
  while True:
    if yield_before_reset:
      yield environment, None, agent, None

    t = 0
    agent.reset()
    timestep_t = environment.reset()

    while True:
      if max_steps_per_episode > 0 and t >= max_steps_per_episode:
        timestep_t = timestep_t._replace(step_type=StepType.LAST)

      a_t = agent.step(timestep_t)
      yield environment, timestep_t, agent, a_t

      a_tm1 = a_t
      t += 1
      if timestep_t.last():
        break  # the LAST timestep was just processed; start a new episode
      timestep_t = environment.step(a_tm1)


def generate_statistics(trackers, timestep_action_sequence
                        ) -> Mapping[str, Any]:
  """Feeds every generator item to every tracker, merges their outputs
  (ref parts.py:125-147)."""
  for tracker in trackers:
    tracker.reset()
  for environment, timestep_t, agent, a_t in timestep_action_sequence:
    for tracker in trackers:
      tracker.step(environment, timestep_t, agent, a_t)
  return dict(collections.ChainMap(*(t.get() for t in trackers)))


class EpisodeTracker:
  """Mean/current episode return, episode & step counts (parts.py:150-247)."""

  def __init__(self):
    self.reset()

  def reset(self) -> None:
    self._num_steps_since_reset = 0
    self._num_steps_over_episodes = 0
    self._episode_returns = []
    self._current_episode_rewards = []
    self._current_episode_step = 0

  def step(self, environment, timestep_t, agent, a_t) -> None:
    del environment, agent, a_t
    if timestep_t is None:
      return
    if timestep_t.first():
      if self._current_episode_rewards:
        raise ValueError("Expected no rewards pending at FIRST.")
      self._current_episode_step = 0
      self._current_episode_rewards = []
    else:
      self._current_episode_rewards.append(timestep_t.reward)
    self._num_steps_since_reset += 1
    self._current_episode_step += 1
    if timestep_t.last():
      self._episode_returns.append(sum(self._current_episode_rewards))
      self._current_episode_rewards = []
      self._num_steps_over_episodes += self._current_episode_step
      self._current_episode_step = 0

  def get(self) -> Mapping[str, Any]:
    if self._episode_returns:
      mean_return = float(np.mean(self._episode_returns))
      current_return = sum(self._current_episode_rewards)
    elif self._num_steps_since_reset > 0:
      mean_return = sum(self._current_episode_rewards)
      current_return = mean_return
    else:
      mean_return = np.nan
      current_return = np.nan
    return {
        "episode_return": mean_return,
        "current_episode_return": current_return,
        "num_episodes": len(self._episode_returns),
        "num_steps_over_episodes": self._num_steps_over_episodes,
        "current_episode_step": self._current_episode_step,
        "num_steps_since_reset": self._num_steps_since_reset,
    }


class StepRateTracker:
  """steps/sec + duration (parts.py:250-284)."""

  def __init__(self):
    self.reset()

  def reset(self) -> None:
    self._num_steps_since_reset = 0
    self._start = timeit.default_timer()

  def step(self, environment, timestep_t, agent, a_t) -> None:
    del environment, timestep_t, agent, a_t
    self._num_steps_since_reset += 1

  def get(self) -> Mapping[str, Any]:
    duration = timeit.default_timer() - self._start
    if self._num_steps_since_reset > 0:
      rate = self._num_steps_since_reset / duration
    else:
      rate = np.nan
    return {"step_rate": rate, "num_steps": self._num_steps_since_reset,
            "duration": duration}


class UnbiasedExponentialWeightedAverageAgentTracker:
  """EWMA of agent statistics with bias correction (parts.py:287-329)."""

  def __init__(self, step_size: float, initial_agent: Agent):
    self._step_size = step_size
    self.trace = 0.0
    self._statistics = dict(initial_agent.statistics)

  def reset(self) -> None:
    self.trace = 0.0
    self._statistics = {k: np.nan for k in self._statistics}

  def step(self, environment, timestep_t, agent, a_t) -> None:
    del environment, timestep_t, a_t
    s = self._step_size
    final_trace = (1 - s) * self.trace + s
    self._statistics = {
        k: ((1 - s) * self.trace * _nan_to_zero(self._statistics[k])
            + s * v) / final_trace
        for k, v in agent.statistics.items()
    }
    self.trace = final_trace

  def get(self) -> Mapping[str, float]:
    return dict(self._statistics)


def _nan_to_zero(x):
  return 0.0 if x != x else x


def make_default_trackers(initial_agent: Agent):
  return [
      EpisodeTracker(),
      StepRateTracker(),
      UnbiasedExponentialWeightedAverageAgentTracker(
          step_size=1e-3, initial_agent=initial_agent),
  ]


class EpsilonGreedyActor(Agent):
  """Eval actor: ε-greedy over a network's Q-values, params set externally
  (ref parts.py:342-411). Works with the host preprocessor and any network
  whose `apply(params, obs)` outputs expose q_values.

  Each act draws (explore_u, random_action) with
  `ops.policy.epsilon_greedy_draws` from the actor's generator, seeded from
  `seed`, through `self.draw(num_actions)`, which a test may replace."""

  def __init__(self, preprocessor, network, exploration_epsilon: float,
               seed: int, device=None):
    self._preprocessor = preprocessor
    self._network = network
    self._epsilon = exploration_epsilon
    self.device = resolve_device(device)
    self._generator = torch.Generator(device=self.device)
    self._generator.manual_seed(seed)
    self._action = None
    self.network_params = None

  def draw(self, num_actions: int):
    """(explore_u (1,), random_action (1,)) for one act."""
    return epsilon_greedy_draws(1, num_actions, self._generator, self.device)

  @torch.no_grad()
  def step(self, timestep) -> Action:
    timestep = self._preprocessor(timestep)
    if timestep is None:
      if self._action is None:
        raise RuntimeError("Cannot repeat if action has never been selected.")
      return self._action
    s_t = torch.from_numpy(np.ascontiguousarray(
        timestep.observation)[None]).to(self.device)
    q_t = self._network.apply(self.network_params, s_t).q_values
    explore_u, random_action = self.draw(q_t.shape[-1])
    a_t = ops.epsilon_greedy_sample(q_t, self._epsilon, explore_u,
                                    random_action)
    self._action = Action(int(a_t[0]))
    return self._action

  def reset(self) -> None:
    from dqn_zoo_torch import processors
    processors.reset(self._preprocessor)
    self._action = None

  def get_state(self) -> Mapping[str, Any]:
    return {"generator": self._generator.get_state(),
            "network_params": self.network_params}

  def set_state(self, state) -> None:
    self._generator.set_state(state["generator"])
    self.network_params = state["network_params"]

  @property
  def statistics(self) -> Mapping[str, float]:
    return {}
