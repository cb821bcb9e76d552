"""The actor-learner superstep (port of dqn_zoo_tpu/engine/superstep.py).

One superstep advances B env streams one agent-step (4 raw frames), inserts
B replay rows and runs gated SGD, in the reference's order:

  1. act on the CURRENT stacks  → actions a_k for observations o_k
  2. insert the PENDING row k   → (o_k's newest frame, a_k, r_k, γ_k, ...)
  3. env.step(a_k)              → group output for o_{k+1}
  4. preprocess + stack update  → o_{k+1}                     (kernel K2)
  5. cache pending row k+1
  6. gated learning: sample (K1) → loss (K3b online, K3a target) → grad →
     the agent's optimizer; target swap on frame-count boundary crossings.

An agent whose actor takes τ samples (IQN: the fused head, kernel K4a) gets
them from the draws too: `act_taus`, U[0, 1) of shape (B, τ samples).

The JAX engine scans supersteps inside one compiled program; here `run` is a
Python loop over `superstep`, which reads two numbers back from the device
per superstep (frames used and replay size) to gate learning and the target
swap. Replay, parameters and optimizer state are updated in place.

Every random number a superstep uses comes from `draw(generator)` as one
`SuperstepDraws`; a caller may pass its own draws instead (the differential
tests hand in the values the JAX engine drew).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, NamedTuple, Optional, Union

import torch

from dqn_zoo_torch import prep
from dqn_zoo_torch.agents.base import (AdamState, AgentSpec, RMSPropState,
                                       make_optimizer)
from dqn_zoo_torch.device import resolve_device
from dqn_zoo_torch.envs.api import get_game
from dqn_zoo_torch.envs.vector import (EnvDraws, VecEnvState, VectorAtariEnv,
                                       VectorEnvConfig)
from dqn_zoo_torch.ops.policy import epsilon_greedy_draws
from dqn_zoo_torch.replay import device_replay as dr
from dqn_zoo_torch.utils.schedules import linear_schedule


@dataclasses.dataclass(frozen=True)
class EngineConfig:
  agent: AgentSpec
  game: str
  num_envs: int
  slots_per_stream: int
  batch_size: int = 32
  learn_every: int = 1  # supersteps between learn blocks
  updates_per_learn: int = 1  # SGD steps per learn block
  total_train_frames: int = 200_000_000  # schedule horizon (all streams)
  env_config: VectorEnvConfig = VectorEnvConfig()
  resize_method: str = "fast"
  pmap_axis: Optional[str] = None
  overlap_env_learn: bool = False
  num_actions: int = 0

  def __post_init__(self):
    if self.overlap_env_learn:
      raise NotImplementedError("overlap_env_learn is not ported yet.")
    if self.pmap_axis is not None:
      raise NotImplementedError("pmap_axis (multi-device) is not ported yet.")
    if self.num_actions:
      raise NotImplementedError("the host env (num_actions) is not ported "
                                "yet.")
    if self.resize_method == "pil":
      raise NotImplementedError("resize_method='pil' is not ported yet.")
    if self.agent.compute_dtype != "float32":
      raise NotImplementedError("the port computes in float32 only.")

  @property
  def replay_capacity(self) -> int:
    return self.num_envs * self.slots_per_stream

  def replay_config(self) -> dr.ReplayConfig:
    a = self.agent
    return dr.ReplayConfig(num_streams=self.num_envs,
                           slots_per_stream=self.slots_per_stream,
                           n_step=a.n_step,
                           priority_exponent=a.priority_exponent)


class PendingRow(NamedTuple):
  """Row k awaiting its action (chosen at the start of the next superstep).
  The initial pending row is terminal, so inserting it is harmless."""

  frame: torch.Tensor  # (B, 84, 84) uint8
  stack_count: torch.Tensor  # (B,)
  reward: torch.Tensor  # (B,) clipped aggregated reward received at o_k
  discount: torch.Tensor  # (B,) aggregated discount ×0.99
  is_terminal: torch.Tensor  # (B,)


class Telemetry(NamedTuple):
  episode_return: torch.Tensor  # (B,)
  episode_frames: torch.Tensor  # (B,)
  completed_return_sum: torch.Tensor  # ()
  completed_count: torch.Tensor  # ()
  last_episode_return: torch.Tensor  # ()
  state_value_ewma: torch.Tensor  # ()
  ewma_trace: torch.Tensor  # ()
  last_loss: torch.Tensor  # ()
  learn_steps: int


class EngineState(NamedTuple):
  env: VecEnvState
  stack: prep.FrameStackState
  pending: PendingRow
  replay: dr.ReplayState
  online_params: Any
  target_params: Any
  opt_state: Union[RMSPropState, AdamState]
  generator: torch.Generator
  env_frames: int  # total raw frames across streams
  superstep: int
  telemetry: Telemetry


class Metrics(NamedTuple):
  env_frames: int
  episodes: float
  mean_episode_return: float
  state_value_ewma: float
  last_loss: float
  exploration_epsilon: float
  replay_size: int
  learn_steps: int


class EvalState(NamedTuple):
  env: VecEnvState
  stack: prep.FrameStackState
  generator: torch.Generator
  env_frames: torch.Tensor  # () int64
  episode_return: torch.Tensor  # (B,)
  completed_return_sum: torch.Tensor
  completed_count: torch.Tensor


class SuperstepDraws(NamedTuple):
  explore_u: torch.Tensor  # (B,) U[0,1) — ε test per env
  random_action: torch.Tensor  # (B,) — action where the env explores
  sample_u: Optional[torch.Tensor]  # (updates, batch) U[0,1) replay draws
  env: EnvDraws
  # (B, tau_samples_policy) U[0,1), only for an agent whose act takes τ.
  act_taus: Optional[torch.Tensor] = None


def leaves(tree) -> List[torch.Tensor]:
  """Parameter leaves of a nested dict in sorted-key order (JAX's order)."""
  if isinstance(tree, dict):
    return [x for k in sorted(tree) for x in leaves(tree[k])]
  return [tree]


class Engine:
  """Builds the train/eval supersteps for one agent+game config."""

  def __init__(self, config: EngineConfig, device=None):
    self.config = config
    self.spec = config.agent
    self.device = resolve_device(device)
    self.game = get_game(config.game)
    self.env = VectorAtariEnv(self.game, config.num_envs, config.env_config,
                              self.device)
    self.network = self.spec.make_network(self.spec, self.game.num_actions)
    self.optimizer = make_optimizer(self.spec)
    self.rcfg = config.replay_config()

  # --- schedules (frame units) ---------------------------------------------

  def exploration_epsilon(self, env_frames) -> float:
    s = self.spec
    if s.greedy_actor:
      return 0.0
    begin_t = s.min_replay_capacity_fraction * self.config.replay_capacity \
        * self.config.env_config.action_repeat
    decay = s.exploration_epsilon_decay_frame_fraction \
        * self.config.total_train_frames
    return float(linear_schedule(
        float(env_frames), begin_value=s.exploration_epsilon_begin,
        end_value=s.exploration_epsilon_end, begin_t=begin_t,
        end_t=begin_t + decay))

  # --- init ------------------------------------------------------------------

  def init(self, seed: int) -> EngineState:
    b, dev = self.config.num_envs, self.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    online = self.network.init(gen, dev)
    for p in leaves(online):
      p.requires_grad_(True)
    target = _tree_map(lambda p: p.detach().clone(), online)
    return EngineState(
        env=self.env.init(gen),
        stack=prep.frame_stack_init(b, dev),
        pending=PendingRow(
            frame=torch.zeros((b, 84, 84), dtype=torch.uint8, device=dev),
            stack_count=torch.ones((b,), dtype=torch.int32, device=dev),
            reward=torch.zeros((b,), device=dev),
            discount=torch.zeros((b,), device=dev),
            is_terminal=torch.ones((b,), dtype=torch.bool, device=dev),
        ),
        replay=dr.replay_init(self.rcfg, dev),
        online_params=online,
        target_params=target,
        opt_state=self.optimizer.init(leaves(online)),
        generator=gen,
        env_frames=0,
        superstep=0,
        telemetry=self.fresh_telemetry(b),
    )

  def fresh_telemetry(self, b: int) -> Telemetry:
    dev = self.device
    z = lambda: torch.zeros((), device=dev)
    return Telemetry(
        episode_return=torch.zeros((b,), device=dev),
        episode_frames=torch.zeros((b,), dtype=torch.int32, device=dev),
        completed_return_sum=z(), completed_count=z(),
        last_episode_return=torch.full((), float("nan"), device=dev),
        state_value_ewma=z(), ewma_trace=z(),
        last_loss=torch.full((), float("nan"), device=dev),
        learn_steps=0)

  def draw(self, gen: torch.Generator, env: Optional[VectorAtariEnv] = None,
           learn: bool = True) -> SuperstepDraws:
    env = env or self.env
    u, a = epsilon_greedy_draws(env.batch_size, self.game.num_actions, gen,
                                self.device)
    act_taus = None
    if self.spec.act_takes_taus:
      act_taus = torch.rand((env.batch_size, self.spec.tau_samples_policy),
                            generator=gen, device=self.device)
    sample_u = None
    if learn:
      sample_u = torch.rand(
          (self.config.updates_per_learn, self.config.batch_size),
          generator=gen, device=self.device)
    return SuperstepDraws(u, a, sample_u, env.draws(gen), act_taus)

  def _act(self, params, obs, epsilon, draws: SuperstepDraws):
    args = (self.spec, self.network, params, obs, epsilon, draws.explore_u,
            draws.random_action)
    if self.spec.act_takes_taus:
      args += (draws.act_taus,)
    return self.spec.act(*args)

  # --- learning --------------------------------------------------------------

  def _sgd_update(self, replay, target, online, opt_state, sample_u):
    batch, _, weights = dr.replay_sample(self.rcfg, replay, sample_u)
    out = self.spec.loss(self.spec, self.network, online, target, batch,
                         weights)
    params = leaves(online)
    grads = torch.autograd.grad(out.loss, params)
    self.optimizer.step(params, list(grads), opt_state)
    return out.loss.detach()

  # --- the superstep -----------------------------------------------------------

  def superstep(self, state: EngineState,
                draws: Optional[SuperstepDraws] = None,
                timings: Optional[Dict[str, float]] = None) -> EngineState:
    """One superstep. `timings`, when given, gets seconds added per stage
    (act, insert, env_prep, learn), each fenced by a device synchronize."""
    cfg = self.config
    if draws is None:
      draws = self.draw(state.generator)
    clock = _StageClock(self.device, timings)

    # 1. act on the current stacks.
    eps = self.exploration_epsilon(state.env_frames)
    actions, values = self._act(state.online_params, state.stack.frames,
                                eps, draws)
    clock.lap("act")

    # 2. insert the pending row, now that its action exists.
    p = state.pending
    replay = dr.replay_insert(self.rcfg, state.replay, p.frame,
                              p.stack_count, actions, p.reward, p.discount,
                              p.is_terminal)
    clock.lap("insert")

    # 3-4. env step + preprocessing.
    env_state, out = self.env.step(state.env, actions, draws.env)
    obs84 = prep.pooled_frame_to_84(out.frame_penult, out.frame_last,
                                    cfg.resize_method)
    stack = prep.frame_stack_update(state.stack, obs84, out.is_first)

    # 5. cache the next pending row (FIRST rows carry zero reward/discount).
    zero = torch.zeros_like(out.reward_sum)
    pending = PendingRow(
        frame=obs84,
        stack_count=stack.count,
        reward=torch.where(out.is_first, zero,
                           torch.clamp(out.reward_sum, -1.0, 1.0)),
        discount=torch.where(out.is_first, zero, out.discount_prod * 0.99),
        is_terminal=out.is_last,
    )
    frames_used, size = torch.stack(
        [out.frames_used.sum().to(torch.int64),
         dr.replay_size(replay).to(torch.int64)]).tolist()
    env_frames = state.env_frames + frames_used
    clock.lap("env_prep")

    # 6. gated learning.
    tel = state.telemetry
    online, opt_state = state.online_params, state.opt_state
    min_fill = self.spec.min_replay_capacity_fraction * cfg.replay_capacity
    last_loss, nupd = tel.last_loss, 0
    if size >= min_fill and state.superstep % cfg.learn_every == 0:
      for u in range(cfg.updates_per_learn):
        last_loss = self._sgd_update(replay, state.target_params, online,
                                     opt_state, draws.sample_u[u])
      nupd = cfg.updates_per_learn

    # 7. target swap on frame-count boundary crossings.
    period = max(1, self.spec.target_network_update_period)
    if state.env_frames // period != env_frames // period:
      with torch.no_grad():
        for t, o in zip(leaves(state.target_params), leaves(online)):
          t.copy_(o)
    clock.lap("learn")

    # 8. telemetry.
    ep_ret = tel.episode_return + out.raw_reward_sum
    finished = out.is_last
    fin_ret = torch.where(finished, ep_ret, zero)
    n_fin = finished.sum()
    last_ret = torch.where(n_fin > 0, fin_ret.sum() / torch.clamp(n_fin, min=1),
                           tel.last_episode_return)
    step_size = 1e-3
    telemetry = Telemetry(
        episode_return=torch.where(finished, zero, ep_ret),
        episode_frames=torch.where(finished,
                                   torch.zeros_like(tel.episode_frames),
                                   tel.episode_frames + out.frames_used),
        completed_return_sum=tel.completed_return_sum + fin_ret.sum(),
        completed_count=tel.completed_count + n_fin,
        last_episode_return=last_ret,
        state_value_ewma=(1.0 - step_size) * tel.state_value_ewma
        + step_size * torch.mean(values),
        ewma_trace=(1.0 - step_size) * tel.ewma_trace + step_size,
        last_loss=last_loss,
        learn_steps=tel.learn_steps + nupd,
    )
    return EngineState(
        env=env_state, stack=stack, pending=pending, replay=replay,
        online_params=online, target_params=state.target_params,
        opt_state=opt_state, generator=state.generator,
        env_frames=env_frames, superstep=state.superstep + 1,
        telemetry=telemetry)

  def run(self, state: EngineState, num_supersteps: int,
          timings: Optional[Dict[str, float]] = None) -> EngineState:
    for _ in range(num_supersteps):
      state = self.superstep(state, timings=timings)
    return state

  def metrics(self, state: EngineState) -> Metrics:
    tel = state.telemetry
    count = float(tel.completed_count)
    mean_ret = (float(tel.completed_return_sum) / count if count > 0
                else float(tel.episode_return.mean()))
    trace = float(tel.ewma_trace)
    ewma = (float(tel.state_value_ewma) / max(trace, 1e-12) if trace > 0
            else float("nan"))
    return Metrics(
        env_frames=state.env_frames,
        episodes=count,
        mean_episode_return=mean_ret,
        state_value_ewma=ewma,
        last_loss=float(tel.last_loss),
        exploration_epsilon=self.exploration_epsilon(state.env_frames),
        replay_size=int(dr.replay_size(state.replay)),
        learn_steps=tel.learn_steps,
    )

  def reset_telemetry(self, state: EngineState) -> EngineState:
    """Per-phase reset of completed-episode sums and last-value scalars;
    in-progress per-stream returns are kept."""
    tel = state.telemetry
    dev = self.device
    return state._replace(telemetry=tel._replace(
        completed_return_sum=torch.zeros((), device=dev),
        completed_count=torch.zeros((), device=dev),
        last_episode_return=torch.full((), float("nan"), device=dev),
        last_loss=torch.full((), float("nan"), device=dev),
    ))

  # --- evaluation ----------------------------------------------------------------

  def _eval_env(self, b: int) -> VectorAtariEnv:
    return VectorAtariEnv(self.game, b, self.config.env_config, self.device)

  def eval_init(self, seed: int, num_envs: Optional[int] = None) -> EvalState:
    b = num_envs or self.config.num_envs
    gen = torch.Generator(device=self.device)
    gen.manual_seed(seed)
    dev = self.device
    return EvalState(
        env=self._eval_env(b).init(gen),
        stack=prep.frame_stack_init(b, dev),
        generator=gen,
        env_frames=torch.zeros((), dtype=torch.int64, device=dev),
        episode_return=torch.zeros((b,), device=dev),
        completed_return_sum=torch.zeros((), device=dev),
        completed_count=torch.zeros((), device=dev),
    )

  def eval_superstep(self, params, state: EvalState,
                     draws: Optional[SuperstepDraws] = None) -> EvalState:
    env = self._eval_env(state.episode_return.shape[0])
    if draws is None:
      draws = self.draw(state.generator, env, learn=False)
    actions, _ = self._act(params, state.stack.frames,
                           self.spec.eval_exploration_epsilon, draws)
    env_state, out = env.step(state.env, actions, draws.env)
    obs84 = prep.pooled_frame_to_84(out.frame_penult, out.frame_last,
                                    self.config.resize_method)
    stack = prep.frame_stack_update(state.stack, obs84, out.is_first)
    ep_ret = state.episode_return + out.raw_reward_sum
    finished = out.is_last
    zero = torch.zeros_like(ep_ret)
    return EvalState(
        env=env_state, stack=stack, generator=state.generator,
        env_frames=state.env_frames + out.frames_used.sum(),
        episode_return=torch.where(finished, zero, ep_ret),
        completed_return_sum=state.completed_return_sum
        + torch.where(finished, ep_ret, zero).sum(),
        completed_count=state.completed_count + finished.sum(),
    )

  def eval_run(self, params, state: EvalState,
               num_supersteps: int) -> EvalState:
    for _ in range(num_supersteps):
      state = self.eval_superstep(params, state)
    return state


def _tree_map(fn, tree):
  if isinstance(tree, dict):
    return {k: _tree_map(fn, v) for k, v in tree.items()}
  return fn(tree)


class _StageClock:
  """Adds fenced wall-clock seconds per stage to `timings` (if given)."""

  def __init__(self, device: torch.device, timings):
    self.timings = timings
    self.device = device
    if timings is not None:
      self._sync()
      self.t = time.perf_counter()

  def _sync(self):
    if self.device.type == "cuda":
      torch.cuda.synchronize(self.device)

  def lap(self, name: str) -> None:
    if self.timings is None:
      return
    self._sync()
    now = time.perf_counter()
    self.timings[name] = self.timings.get(name, 0.0) + now - self.t
    self.t = now
