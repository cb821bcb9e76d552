"""Trainable host-side agent: the reference's single-stream skeleton (port
of dqn_zoo_tpu/host_agent.py).

`processors.AtariProcessor`, the NumPy host replay (`replay/host.py`), the
networks and `parts.run_loop` make a learning agent with the step structure
of the reference's agents (dqn/agent.py:133-158): preprocess (None → repeat
the cached action), act at B = 1, accumulate → replay.add, min-fill gate,
learn at the spec's batch every `learn_period` frames, online → target copy
every `target_network_update_period` frames. One class serves all seven
agents, since an `AgentSpec` carries the network, loss, act, replay flavour
and hyperparameters.

This is the migration path for dqn_zoo users with host code (custom envs,
callbacks, replay introspection); the engines are the throughput path. On
the card the act launches kernel K3a at B = 1; a learn step K3b (online)
and K3a (target, and the double-Q selector where the loss has one) at the
batch size; the replay gathers and the processor resizes on the host, so
K1 and K2 do not run.

Randomness is an input. The replay samples from the NumPy `random_state`;
everything else comes from a `torch.Generator` on the agent's device,
seeded from `seed`, through `self.draw(kind)`, which a test may replace:
`draw("act")` gives what the spec's `act` takes after ε (explore_u,
random_action, and τ or a noise set where the spec's act takes them),
`draw("learn")` what its `loss` takes after the weights (three τ sets or
three noise sets, or nothing).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, Mapping, Optional

import numpy as np
import torch

from dqn_zoo_torch import parts, processors
from dqn_zoo_torch.agents.base import AdamState, AgentSpec, make_optimizer
from dqn_zoo_torch.device import resolve_device
from dqn_zoo_torch.ops.policy import epsilon_greedy_draws
from dqn_zoo_torch.replay import host as replay_lib
from dqn_zoo_torch.utils.pytree import leaves, tree_map
from dqn_zoo_torch.utils.schedules import LinearSchedule


def _opt_tensors(opt_state):
  """The tensors of an optimizer state (RMSPropState or AdamState), in a
  fixed order."""
  out = list(opt_state.mu) + list(opt_state.nu)
  if isinstance(opt_state, AdamState):
    out.append(opt_state.count)
  return out


class HostAgent(parts.Agent):
  """Single-stream learning agent over any AgentSpec (ref dqn/agent.py:60-233).

  `step()` is called once per ENVIRONMENT FRAME; all periods are in frame
  units like the reference flags (README.md:136-138).
  """

  def __init__(
      self,
      spec: AgentSpec,
      num_actions: int,
      sample_network_input: np.ndarray,  # (84,84,4) uint8
      seed: int,
      preprocessor: Optional[Callable] = None,
      replay_capacity: int = 10_000,
      total_frames: int = 1_000_000,
      num_action_repeats: int = 4,
      exploration_epsilon: Optional[Callable[[int], float]] = None,
      random_state: Optional[np.random.RandomState] = None,
      compress_state: bool = False,
      learning_rate: Optional[float] = None,
      device=None,
  ):
    if np.shape(sample_network_input) != (84, 84, 4):
      raise ValueError("the port's networks take (84, 84, 4) observations; "
                       f"got {np.shape(sample_network_input)}.")
    self.spec = spec
    self.device = resolve_device(device)
    self.num_actions = num_actions
    self._preprocessor = preprocessor
    self._batch_size = spec.batch_size
    self._learn_period = spec.learn_period
    self._target_period = spec.target_network_update_period
    self._min_replay_capacity = int(
        spec.min_replay_capacity_fraction * replay_capacity)
    self._frame_t = -1  # current frame index (ref dqn/agent.py:78)
    self._action = None
    self._statistics = {"state_value": np.nan}
    self._max_seen_priority = 1.0  # ref prioritized/agent.py:80

    random_state = random_state or np.random.RandomState(1)
    self._random_state = random_state
    if exploration_epsilon is None:
      if spec.greedy_actor:  # rainbow: noisy-net exploration
        exploration_epsilon = lambda t: 0.0
      else:
        exploration_epsilon = LinearSchedule(
            begin_value=spec.exploration_epsilon_begin,
            end_value=spec.exploration_epsilon_end,
            begin_t=int(self._min_replay_capacity * num_action_repeats),
            decay_steps=int(spec.exploration_epsilon_decay_frame_fraction
                            * total_frames))
    self._exploration_epsilon = exploration_epsilon

    self.network = spec.make_network(spec, num_actions)
    if learning_rate is not None:
      spec = dataclasses.replace(spec, learning_rate=learning_rate)
    self.optimizer = make_optimizer(spec)

    self._generator = torch.Generator(device=self.device)
    self._generator.manual_seed(seed)
    self.online_params = self.network.init(self._generator, self.device)
    for p in leaves(self.online_params):
      p.requires_grad_(True)
    self.target_params = tree_map(lambda p: p.detach().clone(),
                                   self.online_params)
    self._opt_state = self.optimizer.init(leaves(self.online_params))

    # Replay (flavour from the spec; priority_exponent 0 → uniform).
    encoder = decoder = None
    if compress_state:
      def encoder(tr):
        return tr._replace(
            s_tm1=replay_lib.compress_array(tr.s_tm1),
            s_t=replay_lib.compress_array(tr.s_t))

      def decoder(tr):
        return tr._replace(
            s_tm1=replay_lib.uncompress_array(tr.s_tm1),
            s_t=replay_lib.uncompress_array(tr.s_t))
    structure = replay_lib.Transition(
        s_tm1=None, a_tm1=None, r_t=None, discount_t=None, s_t=None)
    self._prioritized = spec.priority_exponent > 0.0
    if self._prioritized:
      # IS exponent anneals over the INSERT counter (ref replay.py:742-745),
      # one insert per agent-step ⇒ total_frames / num_action_repeats.
      is_schedule = LinearSchedule(
          begin_value=spec.importance_sampling_begin,
          end_value=spec.importance_sampling_end,
          begin_t=0,
          decay_steps=max(1, total_frames // num_action_repeats))
      self._replay = replay_lib.PrioritizedTransitionReplay(
          capacity=replay_capacity, structure=structure,
          priority_exponent=spec.priority_exponent,
          importance_sampling_exponent=lambda t: float(is_schedule(t)),
          uniform_sample_probability=spec.uniform_sample_probability,
          normalize_weights=spec.normalize_weights,
          random_state=random_state, encoder=encoder, decoder=decoder)
    else:
      self._replay = replay_lib.TransitionReplay(
          capacity=replay_capacity, structure=structure,
          random_state=random_state, encoder=encoder, decoder=decoder)
    if spec.n_step > 1:
      self._transition_accumulator = replay_lib.NStepTransitionAccumulator(
          spec.n_step)
    else:
      self._transition_accumulator = replay_lib.TransitionAccumulator()

  # --- draws -------------------------------------------------------------------

  def draw(self, kind: str) -> tuple:
    """The random arguments of one act ("act") or one learn step ("learn"),
    from the agent's generator."""
    g, dev, s = self._generator, self.device, self.spec
    if kind == "act":
      out = tuple(epsilon_greedy_draws(1, self.num_actions, g, dev))
      if s.act_takes_taus:
        out += (torch.rand((1, s.tau_samples_policy), generator=g,
                           device=dev),)
      if s.act_takes_noise:
        out += (self.network.draw_noise(g, dev),)
      return out
    if kind != "learn":
      raise ValueError(f"kind must be 'act' or 'learn'; got {kind!r}.")
    out = ()
    if s.loss_takes_taus:
      out += tuple(torch.rand((self._batch_size, n), generator=g, device=dev)
                   for n in (s.tau_samples_s_tm1, s.tau_samples_policy,
                             s.tau_samples_s_t))
    if s.loss_takes_noise:
      both = self.network.draw_noise(g, dev, (3,))
      out += tuple(type(both)(*(x[j] for x in both)) for j in range(3))
    return out

  # --- reference step skeleton (dqn/agent.py:133-158) -----------------------

  def step(self, timestep) -> parts.Action:
    self._frame_t += 1
    ts = self._preprocessor(timestep) if self._preprocessor else timestep
    if ts is None:  # action-repeat frame: repeat the cached action
      if self._action is None:
        raise RuntimeError("Cannot repeat if action has never been selected.")
      action = self._action
    else:
      action = self._action = self._act(ts)
      for transition in self._transition_accumulator.step(ts, action):
        if self._prioritized:
          self._replay.add(transition, priority=self._max_seen_priority)
        else:
          self._replay.add(transition)

    if self._replay.size < self._min_replay_capacity:
      return action
    if self._frame_t % self._learn_period == 0:
      self._learn()
    if self._frame_t % self._target_period == 0:
      with torch.no_grad():
        for t, o in zip(leaves(self.target_params),
                        leaves(self.online_params)):
          t.copy_(o)
    return action

  def _upload(self, x: np.ndarray, dtype) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, dtype=dtype)).to(
        self.device)

  @torch.no_grad()
  def _act(self, timestep) -> parts.Action:
    s_t = self._upload(np.asarray(timestep.observation)[None], np.uint8)
    epsilon = float(self._exploration_epsilon(self._frame_t))
    actions, values = self.spec.act(self.spec, self.network,
                                    self.online_params, s_t, epsilon,
                                    *self.draw("act"))
    # One read-back for both: an action index is exact in float32.
    a_t, v_t = torch.stack([actions[0].to(values.dtype), values[0]]).tolist()
    self._statistics["state_value"] = v_t
    return parts.Action(int(a_t))

  def _learn(self) -> None:
    if self._prioritized:
      transitions, ids, weights = self._replay.sample(self._batch_size)
      weights = self._upload(weights, np.float32)
    else:
      transitions = self._replay.sample(self._batch_size)
      ids = None
      weights = torch.ones((self._batch_size,), device=self.device)
    batch = transitions._replace(
        s_tm1=self._upload(transitions.s_tm1, np.uint8),
        a_tm1=self._upload(transitions.a_tm1, np.int64),
        r_t=self._upload(transitions.r_t, np.float32),
        discount_t=self._upload(transitions.discount_t, np.float32),
        s_t=self._upload(transitions.s_t, np.uint8))
    out = self.spec.loss(self.spec, self.network, self.online_params,
                         self.target_params, batch, weights,
                         *self.draw("learn"))
    params = leaves(self.online_params)
    grads = torch.autograd.grad(out.loss, params)
    self.optimizer.step(params, list(grads), self._opt_state)
    self._statistics["loss"] = float(out.loss.detach())
    if self._prioritized:
      priorities = out.priorities.detach().cpu().numpy().astype(np.float64)
      max_priority = float(priorities.max()) if priorities.size else 1.0
      self._max_seen_priority = max(self._max_seen_priority, max_priority)
      self._replay.update_priorities(ids, priorities)

  def reset(self) -> None:
    self._transition_accumulator.reset()
    if self._preprocessor is not None:
      processors.reset(self._preprocessor)
    self._action = None

  # --- checkpointable state (ref dqn/agent.py:210-229) ----------------------

  def get_state(self) -> Mapping[str, Any]:
    """A snapshot: tensors are copies, so the agent's later steps leave it
    as it was."""
    return {
        "generator": self._generator.get_state(),
        "frame_t": self._frame_t,
        "opt_state": copy.deepcopy(self._opt_state),
        "online_params": copy.deepcopy(self.online_params),
        "target_params": copy.deepcopy(self.target_params),
        "replay": self._replay.get_state(),
        "max_seen_priority": self._max_seen_priority,
        # The replay's host RNG: the reference checkpoints it at the runner
        # level (dqn/run_atari.py:102-105, 239-246); here the agent owns it
        # so a state transplant is fully deterministic.
        "random_state": self._random_state.get_state(),
    }

  def set_state(self, state: Mapping[str, Any]) -> None:
    """Copies `state` into the agent's own tensors (on its device)."""
    self._generator.set_state(state["generator"])
    self._frame_t = state["frame_t"]
    with torch.no_grad():
      for dst, src in (
          (leaves(self.online_params), leaves(state["online_params"])),
          (leaves(self.target_params), leaves(state["target_params"])),
          (_opt_tensors(self._opt_state), _opt_tensors(state["opt_state"]))):
        if len(dst) != len(src):
          raise ValueError("state does not match the agent's structure.")
        for d, s in zip(dst, src):
          d.copy_(s)
    self._replay.set_state(state["replay"])
    self._max_seen_priority = state["max_seen_priority"]
    if "random_state" in state:
      self._random_state.set_state(state["random_state"])

  @property
  def statistics(self) -> Mapping[str, float]:
    return {k: v for k, v in self._statistics.items() if k == "state_value"}
