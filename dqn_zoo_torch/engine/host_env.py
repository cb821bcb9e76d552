"""Actor-learner engine over HOST environments (port of
dqn_zoo_tpu/engine/host_env.py): the C++ farm, or the ALE through it.

The algorithm is engine/superstep.py's, but the env lives on the host, so a
superstep is one device half-step over the group the farm returned:

  host:   the farm steps B envs (previous actions) → HostGroupOutput
  device: upload → stack update → act → replay insert → gated SGD → target
          swap; the actions (B,) back to the host

The half-step waits on the card once, for the actions and the replay size
together, before it launches the learn block; the farm then steps the next
group on the host while the card still runs that block. The frame counts
are the farm's host numbers, so nothing else is read back.

Every random number comes from the engine's `SuperstepDraws` (ε, τ, noise
and the replay's `sample_u`; no env draws, the farm owns its RNG), made by
`draw(generator)` or handed in by the caller.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from dqn_zoo_torch import prep
from dqn_zoo_torch.agents.base import AdamState, RMSPropState
from dqn_zoo_torch.engine.superstep import (Engine, EngineConfig,
                                            SuperstepDraws, Telemetry)
from dqn_zoo_torch.envs.cpp_bridge import CppVectorEnv, HostGroupOutput
from dqn_zoo_torch.replay import device_replay as dr
from dqn_zoo_torch.utils import profiling


class HostEngineState(NamedTuple):
  stack: prep.FrameStackState
  replay: dr.ReplayState
  online_params: Any
  target_params: Any
  opt_state: Union[RMSPropState, AdamState]
  generator: torch.Generator
  env_frames: int  # total raw frames across streams (host)
  superstep: int
  telemetry: Telemetry


class HostEnvEngine:
  """Drives a host vector env against the device half-step."""

  def __init__(self, config: EngineConfig, env: CppVectorEnv, device=None):
    if env.batch_size != config.num_envs:
      raise ValueError("env.batch_size must match config.num_envs")
    # The host env sets the action set: an ALE-only cartridge (no device
    # game) then sizes the network from it.
    config = dataclasses.replace(config, num_actions=env.num_actions)
    self._fused = Engine(config, device)  # its network, optimizer, schedules
    self.device = self._fused.device
    if env.device != self.device:
      raise ValueError(f"the env uploads to {env.device}, the engine runs "
                       f"on {self.device}")
    self.config = config
    self.spec = config.agent
    self.env = env
    self.network = self._fused.network
    self.rcfg = self._fused.rcfg

  def init(self, seed: int) -> HostEngineState:
    full = self._fused.init(seed)
    return HostEngineState(
        stack=full.stack, replay=full.replay,
        online_params=full.online_params, target_params=full.target_params,
        opt_state=full.opt_state, generator=full.generator,
        env_frames=full.env_frames, superstep=full.superstep,
        telemetry=full.telemetry)

  def draw(self, gen: torch.Generator) -> SuperstepDraws:
    return self._fused.agent_draws(gen, self.config.num_envs)

  # --- the device half-step ------------------------------------------------

  def step(self, state: HostEngineState, group: HostGroupOutput,
           draws: Optional[SuperstepDraws] = None,
           timings: Optional[Dict[str, float]] = None
           ) -> Tuple[HostEngineState, np.ndarray]:
    """One superstep over `group` (which this engine's env returned);
    returns the new state and the actions (B,) int32 for the farm's next
    step. `timings`, when given, gets seconds added per stage (upload, act,
    insert, learn), each fenced by a device synchronize.

    Its spans: the root `superstep` over draw, upload, act, insert,
    sync.gate, learn (as in Engine.superstep), target_swap and
    telemetry."""
    cfg, eng = self.config, self._fused
    profiling.root("superstep", state.superstep)
    if draws is None:
      with profiling.span("draw"):
        draws = self.draw(state.generator)
    fence = profiling.fence(self.device, timings)
    with profiling.span("upload"):
      out = self.env.upload(group)
    fence.lap("upload")

    with profiling.span("act"):
      stack = prep.frame_stack_update(state.stack, out.obs84, out.is_first)
      actions, values = eng._act(state.online_params, stack.frames,
                                 eng.exploration_epsilon(state.env_frames),
                                 draws)
    fence.lap("act")

    # This step's observation and action, with the reward that led to it
    # (FIRST rows carry zero reward and discount).
    with profiling.span("insert"):
      zero = torch.zeros_like(out.reward_sum)
      replay = dr.replay_insert(
          self.rcfg, state.replay, out.obs84, stack.count, actions,
          torch.where(out.is_first, zero, torch.clamp(out.reward_sum, -1.0,
                                                      1.0)),
          torch.where(out.is_first, zero, out.discount_prod * 0.99),
          out.is_last)
      gate = torch.cat([actions.to(torch.int64), eng.gate_size(replay)])
    env_frames = state.env_frames + int(group.frames_used.sum())
    # The one wait on the card: the actions and the replay size together.
    back = profiling.host_read(gate, "gate")
    actions_np = np.asarray(back[:-1], dtype=np.int32)
    size = back[-1]
    fence.lap("insert")

    tel = state.telemetry
    online, opt_state = state.online_params, state.opt_state
    min_fill = self.spec.min_replay_capacity_fraction * cfg.replay_capacity
    last_loss, nupd = tel.last_loss, 0
    if size >= min_fill and state.superstep % cfg.learn_every == 0:
      last_loss = eng.learn(replay, state.target_params, online, opt_state,
                            draws)
      nupd = cfg.updates_per_learn
    with profiling.span("target_swap"):
      eng.swap_target(state.target_params, online, state.env_frames,
                      env_frames)

    # Telemetry as the JAX host engine keeps it (no last episode return).
    with profiling.span("telemetry"):
      ep_ret = tel.episode_return + out.reward_sum
      finished = out.is_last
      step_size = 1e-3
      telemetry = Telemetry(
          episode_return=torch.where(finished, zero, ep_ret),
          episode_frames=torch.where(finished,
                                     torch.zeros_like(tel.episode_frames),
                                     tel.episode_frames + out.frames_used),
          completed_return_sum=tel.completed_return_sum
          + torch.where(finished, ep_ret, zero).sum(),
          completed_count=tel.completed_count + finished.sum(),
          last_episode_return=tel.last_episode_return,
          state_value_ewma=(1.0 - step_size) * tel.state_value_ewma
          + step_size * torch.mean(values),
          ewma_trace=(1.0 - step_size) * tel.ewma_trace + step_size,
          last_loss=last_loss,
          learn_steps=tel.learn_steps + nupd,
      )
    fence.lap("learn")
    profiling.end()
    return HostEngineState(
        stack=stack, replay=replay, online_params=online,
        target_params=state.target_params, opt_state=opt_state,
        generator=state.generator, env_frames=env_frames,
        superstep=state.superstep + 1, telemetry=telemetry), actions_np

  # --- the host loop ---------------------------------------------------------

  def run(self, state: HostEngineState, num_supersteps: int,
          timings: Optional[Dict[str, float]] = None) -> HostEngineState:
    """`num_supersteps` supersteps, the first over a farm step with action
    0 everywhere (as the JAX engine's run begins). `timings` as in `step`,
    with the farm's host seconds under "farm"."""
    actions = np.zeros((self.config.num_envs,), np.int32)
    group = self._farm_step(actions, timings)
    for _ in range(num_supersteps):
      state, actions = self.step(state, group, timings=timings)
      # The farm steps while the card still runs the learn block.
      group = self._farm_step(actions, timings)
    return state

  def _farm_step(self, actions: np.ndarray,
                 timings: Optional[Dict[str, float]]) -> HostGroupOutput:
    t0 = time.perf_counter()
    group = self.env.step(actions)
    if timings is not None:
      timings["farm"] = timings.get("farm", 0.0) + time.perf_counter() - t0
    return group

  def metrics(self, state: HostEngineState) -> Dict[str, Any]:
    tel = state.telemetry
    return {
        "env_frames": state.env_frames,
        "episodes": int(tel.completed_count),
        "mean_episode_return": float(tel.completed_return_sum / torch.clamp(
            tel.completed_count, min=1.0)),
        "learn_steps": tel.learn_steps,
        "last_loss": float(tel.last_loss),
    }
