"""The actor-learner superstep (port of dqn_zoo_tpu/engine/superstep.py).

One superstep advances B env streams one agent-step (4 raw frames), inserts
B replay rows and runs gated SGD, in the reference's order:

  1. act on the CURRENT stacks  → actions a_k for observations o_k
  2. insert the PENDING row k   → (o_k's newest frame, a_k, r_k, γ_k, ...)
  3. env.step(a_k)              → group output for o_{k+1}
  4. preprocess + stack update  → o_{k+1}                     (kernel K2)
  5. cache pending row k+1
  6. gated learning: sample (K1) → loss (K3b online, K3a target, and K3a
     again for a double-Q selector) → grad → the agent's optimizer → new
     priorities (prioritized replay); target swap on frame-count boundary
     crossings.

In overlap mode (`EngineConfig.overlap_env_learn`) step 2 runs after step
6, so learning reads the replay as it was before this superstep's insert.

An agent whose actor takes τ samples (IQN: the fused head, kernel K4a) gets
them from the draws too: `act_taus`, U[0, 1) of shape (B, τ samples). So
does a loss that takes τ samples (IQN: K4a forward, K4b and K4c backward):
`loss_taus`, three sets per update. An agent whose network has noisy layers
(rainbow) gets their noise the same way: `act_noise`, one set per act, and
`loss_noise`, three sets per update, each drawn by the network's
`draw_noise`.

The JAX engine scans supersteps inside one compiled program; here `run` is a
Python loop over `superstep`, which reads two numbers back from the device
per superstep (frames used and replay size) to gate learning and the target
swap. Replay, parameters and optimizer state are updated in place.

Data parallelism (`EngineConfig.pmap_axis`, parallel/distributed.py): one
engine per rank of a `torch.distributed` process group, each with its own
envs, replay and draws. Each SGD step mean-all-reduces the gradients over
the group, so the replicated parameters stay equal on every rank, and the
schedules count global frames by scaling the rank's own counters by
`frame_multiplier`.

Every random number a superstep uses comes from `draw(generator)` as one
`SuperstepDraws`; a caller may pass its own draws instead (the differential
tests hand in the values the JAX engine drew).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Union

import torch
import torch.distributed as dist

from dqn_zoo_torch import prep
from dqn_zoo_torch.agents.base import (AdamState, AgentSpec, RMSPropState,
                                       make_optimizer)
from dqn_zoo_torch.device import resolve_device
from dqn_zoo_torch.envs.api import get_game
from dqn_zoo_torch.envs.vector import (EnvDraws, VecEnvState, VectorAtariEnv,
                                       VectorEnvConfig)
from dqn_zoo_torch.nets.core import COMPUTE_DTYPES
from dqn_zoo_torch.ops.policy import epsilon_greedy_draws
from dqn_zoo_torch.replay import device_replay as dr
from dqn_zoo_torch.utils import profiling
from dqn_zoo_torch.utils.pytree import leaves, tree_map
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
  # Overlap mode: learn samples the replay as it was before this
  # superstep's insert, and the insert runs after the learn block, on the
  # trees whose priorities that block wrote (so the min-fill gate opens one
  # superstep later). A sampled batch never holds the row inserted in the
  # same superstep.
  overlap_env_learn: bool = False
  # The action-set size of a game with no device implementation (an
  # ALE-only cartridge driven through engine/host_env.py): the engine then
  # builds no device env and sizes the network from this. 0 = the device
  # game's own.
  num_actions: int = 0
  # Number of ranks running this engine side by side (data parallelism):
  # the schedules (ε, β, target swaps) read the rank's own frame and insert
  # counters scaled by this factor, so they count global frames with no
  # collective.
  frame_multiplier: int = 1

  def __post_init__(self):
    if self.agent.compute_dtype not in COMPUTE_DTYPES:
      raise ValueError(f"compute_dtype must be one of {list(COMPUTE_DTYPES)}"
                       f"; got {self.agent.compute_dtype!r}.")

  @property
  def replay_capacity(self) -> int:
    return self.num_envs * self.slots_per_stream

  def replay_config(self) -> dr.ReplayConfig:
    a = self.agent
    # IS weights are normalized per chunk of the agent's own batch, so that
    # throughput mode's big batch keeps the reference's per-update weight
    # scale (without it prioritized/pong stayed flat on the TPU).
    return dr.ReplayConfig(num_streams=self.num_envs,
                           slots_per_stream=self.slots_per_stream,
                           n_step=a.n_step,
                           priority_exponent=a.priority_exponent,
                           uniform_sample_probability=(
                               a.uniform_sample_probability),
                           normalize_weights=a.normalize_weights,
                           normalize_weights_chunk=a.batch_size)


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
  # U[0,1) replay draws: (updates, batch) for uniform replay, (updates, 3,
  # batch) for prioritized replay (the u, p and mix streams).
  sample_u: Optional[torch.Tensor]
  env: EnvDraws
  # (B, tau_samples_policy) U[0,1), only for an agent whose act takes τ.
  act_taus: Optional[torch.Tensor] = None
  # (tau_tm1, tau_sel, tau_t), each (updates, batch, n) U[0,1), only for an
  # agent whose loss takes τ and only when learning.
  loss_taus: Optional[tuple] = None
  # One noise set of the network's noisy layers, only for an agent whose act
  # takes noise.
  act_noise: Any = None
  # (noise_tm1, noise_sel, noise_t), each a noise set whose tensors have a
  # leading (updates,) axis, only for an agent whose loss takes noise and
  # only when learning.
  loss_noise: Optional[tuple] = None


class Engine:
  """Builds the train/eval supersteps for one agent+game config."""

  def __init__(self, config: EngineConfig, device=None, group=None):
    """`group`: the process group whose ranks run this engine side by side
    when `config.pmap_axis` is set (None: the default group)."""
    self.config = config
    self.spec = config.agent
    self.device = resolve_device(device)
    self.group = group
    self.world_size = 1
    if config.pmap_axis is not None:
      if not dist.is_initialized():
        raise RuntimeError("pmap_axis needs a torch.distributed process "
                           "group (parallel.init_distributed).")
      self.world_size = dist.get_world_size(group)
    try:
      self.game = get_game(config.game)
    except KeyError:
      if config.num_actions <= 0:
        raise
      self.game = None  # an ALE-only cartridge: the host env steps it
    if self.game is not None:
      self.env = VectorAtariEnv(self.game, config.num_envs,
                                config.env_config, self.device)
      self.num_actions = self.game.num_actions
    else:
      self.env = None
      self.num_actions = config.num_actions
    self.network = self.spec.make_network(self.spec, self.num_actions)
    self.optimizer = make_optimizer(self.spec)
    self.rcfg = config.replay_config()

  # --- schedules (frame units) ---------------------------------------------

  def exploration_epsilon(self, env_frames) -> float:
    s = self.spec
    if s.greedy_actor:
      return 0.0
    m = self.config.frame_multiplier
    begin_t = s.min_replay_capacity_fraction * self.config.replay_capacity \
        * m * self.config.env_config.action_repeat
    decay = s.exploration_epsilon_decay_frame_fraction \
        * self.config.total_train_frames
    return float(linear_schedule(
        _f32(env_frames) * m, begin_value=s.exploration_epsilon_begin,
        end_value=s.exploration_epsilon_end, begin_t=begin_t,
        end_t=begin_t + decay))

  def importance_sampling_exponent(self, inserted_transitions) -> float:
    """β, annealed over inserted transitions from the min fill to the end of
    training (in agent steps)."""
    s = self.spec
    m = self.config.frame_multiplier
    return float(linear_schedule(
        _f32(inserted_transitions) * m,
        begin_value=s.importance_sampling_begin,
        end_value=s.importance_sampling_end,
        begin_t=s.min_replay_capacity_fraction * self.config.replay_capacity
        * m,
        end_t=self.config.total_train_frames
        // self.config.env_config.action_repeat))

  # --- init ------------------------------------------------------------------

  def init(self, seed: int) -> EngineState:
    b, dev = self.config.num_envs, self.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    online = self.network.init(gen, dev)
    for p in leaves(online):
      p.requires_grad_(True)
    target = tree_map(lambda p: p.detach().clone(), online)
    return EngineState(
        env=self.env.init(gen) if self.env is not None else None,
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
    return self.agent_draws(gen, env.batch_size, learn)._replace(
        env=env.draws(gen))

  def agent_draws(self, gen: torch.Generator, batch: int,
                  learn: bool = True) -> SuperstepDraws:
    """The draws of `draw` but the env's (left None), in the same order:
    the env's come last."""
    u, a = epsilon_greedy_draws(batch, self.num_actions, gen, self.device)
    act_taus = act_noise = None
    if self.spec.act_takes_taus:
      act_taus = torch.rand((batch, self.spec.tau_samples_policy),
                            generator=gen, device=self.device)
    if self.spec.act_takes_noise:
      act_noise = self.network.draw_noise(gen, self.device)
    sample_u = loss_taus = loss_noise = None
    if learn:
      shape = (self.config.updates_per_learn, self.config.batch_size)
      u_shape = (shape if self.rcfg.priority_exponent == 0
                 else (shape[0], 3, shape[1]))
      sample_u = torch.rand(u_shape, generator=gen, device=self.device)
      if self.spec.loss_takes_taus:
        s = self.spec
        loss_taus = tuple(
            torch.rand(shape + (n,), generator=gen, device=self.device)
            for n in (s.tau_samples_s_tm1, s.tau_samples_policy,
                      s.tau_samples_s_t))
      if self.spec.loss_takes_noise:
        # One draw of (updates, 3) sets, split into the three.
        both = self.network.draw_noise(gen, self.device, (shape[0], 3))
        loss_noise = tuple(type(both)(*(x[:, j] for x in both))
                           for j in range(3))
    return SuperstepDraws(u, a, sample_u, None, act_taus, loss_taus,
                          act_noise, loss_noise)

  def _act(self, params, obs, epsilon, draws: SuperstepDraws):
    args = (self.spec, self.network, params, obs, epsilon, draws.explore_u,
            draws.random_action)
    if self.spec.act_takes_taus:
      args += (draws.act_taus,)
    if self.spec.act_takes_noise:
      args += (draws.act_noise,)
    return self.spec.act(*args)

  # --- learning --------------------------------------------------------------

  def _sgd_update(self, replay, target, online, opt_state, sample_u,
                  loss_args=()):
    """One SGD step; with prioritized replay it then writes the sampled
    rows' new priorities, so the next step samples the updated tree.
    `loss_args` are the update's τ sets and noise sets, if the loss takes
    any."""
    beta = self.importance_sampling_exponent(replay.t * self.config.num_envs)
    with profiling.span("learn.sample"):
      batch, sampled, weights = dr.replay_sample(self.rcfg, replay, sample_u,
                                                 beta)
    with profiling.span("learn.loss"):
      out = self.spec.loss(self.spec, self.network, online, target, batch,
                           weights, *loss_args)
    params = leaves(online)
    with profiling.span("learn.backward"):
      grads = torch.autograd.grad(out.loss, params)
    if self.config.pmap_axis is not None:
      with profiling.span("learn.allreduce"):
        grads = self._mean_over_ranks(grads)
    with profiling.span("learn.optimizer"):
      self.optimizer.step(params, list(grads), opt_state)
    if self.rcfg.priority_exponent > 0:
      with profiling.span("learn.priorities"):
        dr.replay_update_priorities(self.rcfg, replay, sampled,
                                    out.priorities)
    return out.loss.detach()

  def _mean_over_ranks(self, grads):
    """The gradients' mean over the ranks: one SUM all-reduce of all leaves
    in one flat buffer, then a division by the world size (exact at one
    and two ranks, where it equals XLA's pmean bit for bit)."""
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=self.group)
    flat /= self.world_size
    return [v.view_as(g) for v, g in
            zip(flat.split([g.numel() for g in grads]), grads)]

  def gate_size(self, replay) -> torch.Tensor:
    """(1,) int64 on the device: the replay size the learn gate reads.

    Every rank must take the same decision, or one rank would wait in the
    gradient all-reduce for a rank that skipped learning. The superstep
    count is equal on every rank, but the replay size is not: it counts
    active rows, and a terminal row never activates, so a rank whose
    episodes ended more often holds fewer. With several ranks the gate
    therefore reads the least size over the ranks (one 8-byte MIN
    all-reduce a superstep)."""
    size = dr.replay_size(replay).to(torch.int64).view(1)
    if self.world_size > 1:
      dist.all_reduce(size, op=dist.ReduceOp.MIN, group=self.group)
    return size

  def learn(self, replay, target, online, opt_state,
            draws: SuperstepDraws) -> torch.Tensor:
    """The learn block: `updates_per_learn` SGD steps, each with its own
    replay draws, τ sets and noise sets; returns the last loss."""
    with profiling.span("learn"):
      for u in range(self.config.updates_per_learn):
        args = tuple(t[u] for t in draws.loss_taus or ()) + tuple(
            type(n)(*(x[u] for x in n)) for n in draws.loss_noise or ())
        loss = self._sgd_update(replay, target, online, opt_state,
                                draws.sample_u[u], args)
    return loss

  def swap_target(self, target, online, frames_before: int,
                  frames_after: int) -> None:
    """Copies the online parameters into the target's where the env frame
    count crossed a multiple of the agent's target period, which counts
    global frames (the rank's own divided by `frame_multiplier`)."""
    period = max(1, self.spec.target_network_update_period
                 // self.config.frame_multiplier)
    if frames_before // period != frames_after // period:
      with torch.no_grad():
        for t, o in zip(leaves(target), leaves(online)):
          t.copy_(o)

  # --- the superstep -----------------------------------------------------------

  def superstep(self, state: EngineState,
                draws: Optional[SuperstepDraws] = None,
                timings: Optional[Dict[str, float]] = None) -> EngineState:
    """One superstep. `timings`, when given, gets seconds added per stage
    (act, insert, env_prep, learn), each fenced by a device synchronize.

    Its spans (utils/profiling.py): the root `superstep` (step: the
    superstep's index) over draw, act, insert, env.step, prep, sync.gate,
    learn (learn.sample, learn.loss, learn.backward, learn.allreduce with
    data parallelism, learn.optimizer, learn.priorities with prioritized
    replay), target_swap and telemetry."""
    cfg = self.config
    profiling.root("superstep", state.superstep)
    if draws is None:
      with profiling.span("draw"):
        draws = self.draw(state.generator)
    fence = profiling.fence(self.device, timings)

    # 1. act on the current stacks.
    with profiling.span("act"):
      eps = self.exploration_epsilon(state.env_frames)
      actions, values = self._act(state.online_params, state.stack.frames,
                                  eps, draws)
    fence.lap("act")

    # 2. insert the pending row, now that its action exists (in overlap
    # mode after the learn block).
    p = state.pending

    def insert(replay):
      with profiling.span("insert"):
        replay = dr.replay_insert(self.rcfg, replay, p.frame, p.stack_count,
                                  actions, p.reward, p.discount,
                                  p.is_terminal)
      fence.lap("insert")
      return replay

    replay = state.replay if cfg.overlap_env_learn else insert(state.replay)

    # 3-4. env step + preprocessing.
    with profiling.span("env.step"):
      env_state, out = self.env.step(state.env, actions, draws.env)
    with profiling.span("prep"):
      obs84 = prep.pooled_frame_to_84(out.frame_penult, out.frame_last,
                                      cfg.resize_method)
      stack = prep.frame_stack_update(state.stack, obs84, out.is_first)

      # 5. cache the next pending row (FIRST rows carry zero
      # reward/discount).
      zero = torch.zeros_like(out.reward_sum)
      pending = PendingRow(
          frame=obs84,
          stack_count=stack.count,
          reward=torch.where(out.is_first, zero,
                             torch.clamp(out.reward_sum, -1.0, 1.0)),
          discount=torch.where(out.is_first, zero, out.discount_prod * 0.99),
          is_terminal=out.is_last,
      )
      gate = torch.cat([out.frames_used.sum().to(torch.int64).view(1),
                        self.gate_size(replay)])
    frames_used, size = profiling.host_read(gate, "gate")
    env_frames = state.env_frames + frames_used
    fence.lap("env_prep")

    # 6. gated learning. The gate reads only numbers equal on every rank (the
    # superstep count and the least replay size over the ranks): with data
    # parallelism a rank that learned alone would deadlock in the gradient
    # all-reduce.
    tel = state.telemetry
    online, opt_state = state.online_params, state.opt_state
    min_fill = self.spec.min_replay_capacity_fraction * cfg.replay_capacity
    last_loss, nupd = tel.last_loss, 0
    if size >= min_fill and state.superstep % cfg.learn_every == 0:
      last_loss = self.learn(replay, state.target_params, online, opt_state,
                             draws)
      nupd = cfg.updates_per_learn

    # 7. target swap on frame-count boundary crossings.
    with profiling.span("target_swap"):
      self.swap_target(state.target_params, online, state.env_frames,
                       env_frames)
    fence.lap("learn")
    if cfg.overlap_env_learn:
      replay = insert(replay)

    # 8. telemetry.
    with profiling.span("telemetry"):
      ep_ret = tel.episode_return + out.raw_reward_sum
      finished = out.is_last
      fin_ret = torch.where(finished, ep_ret, zero)
      n_fin = finished.sum()
      last_ret = torch.where(n_fin > 0,
                             fin_ret.sum() / torch.clamp(n_fin, min=1),
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
    profiling.end()
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
    """One eval superstep; its spans: the root `eval.superstep` over draw,
    act, env.step and prep."""
    env = self._eval_env(state.episode_return.shape[0])
    profiling.root("eval.superstep")
    if draws is None:
      with profiling.span("draw"):
        draws = self.draw(state.generator, env, learn=False)
    with profiling.span("act"):
      actions, _ = self._act(params, state.stack.frames,
                             self.spec.eval_exploration_epsilon, draws)
    with profiling.span("env.step"):
      env_state, out = env.step(state.env, actions, draws.env)
    with profiling.span("prep"):
      obs84 = prep.pooled_frame_to_84(out.frame_penult, out.frame_last,
                                      self.config.resize_method)
      stack = prep.frame_stack_update(state.stack, obs84, out.is_first)
    ep_ret = state.episode_return + out.raw_reward_sum
    finished = out.is_last
    zero = torch.zeros_like(ep_ret)
    new = EvalState(
        env=env_state, stack=stack, generator=state.generator,
        env_frames=state.env_frames + out.frames_used.sum(),
        episode_return=torch.where(finished, zero, ep_ret),
        completed_return_sum=state.completed_return_sum
        + torch.where(finished, ep_ret, zero).sum(),
        completed_count=state.completed_count + finished.sum(),
    )
    profiling.end()
    return new

  def eval_run(self, params, state: EvalState,
               num_supersteps: int) -> EvalState:
    for _ in range(num_supersteps):
      state = self.eval_superstep(params, state)
    return state


def _f32(x) -> torch.Tensor:
  """A count as the JAX engine's float32 scalar."""
  return torch.as_tensor(float(x), dtype=torch.float32)

