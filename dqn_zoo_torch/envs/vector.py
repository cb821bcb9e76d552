"""Batched env wrapper: action repeat, noop starts, truncation, auto-reset.

Port of dqn_zoo_tpu/envs/vector.py. The reference vmaps a single-env step and
picks the reset or the step branch per env with `lax.cond`; here both run on
the whole batch and a per-env `torch.where` picks, which is the same thing
for envs that are independent. The reset branch (a new episode after 1..30
noop frames) only runs in a superstep where some env needs it.

Kept from the reference: action repeat 4 with post-terminal substeps masked
out, the penultimate/last frame capture at substeps 3 and 4, the life-loss
discount, the 108k-frame episode cap (truncation, which bootstraps) and the
auto-reset that emits a FIRST group.

A game with `per_frame_draws` (seaquest) gets draws with a leading frame
axis, one slice for each raw frame of the group and of the noop burn, as
the reference splits a new key on every frame; the others get one set that
serves every frame.

On the card the reset branch's device work (the burn, and the new
episodes' frame and lives) is one CUDA graph, captured on the first reset
and replayed on the later ones: the same kernels on the same inputs as the
eager branch, which the CPU keeps, with one launch from the host in place
of a few thousand.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Tuple

import torch

from dqn_zoo_torch.device import resolve_device
from dqn_zoo_torch.envs.api import (FRAME_HEIGHT, FRAME_WIDTH, Game,
                                    GroupOutput, tree_where)
from dqn_zoo_torch.utils import profiling


@dataclasses.dataclass(frozen=True)
class VectorEnvConfig:
  action_repeat: int = 4
  max_noops: int = 30
  noop_action: int = 0
  episode_frame_cap: int = 108_000  # raw frames


class VecEnvState(NamedTuple):
  game_state: Any  # batched game NamedTuple (leading dim B)
  episode_frames: torch.Tensor  # (B,) int32 raw frames this episode
  needs_reset: torch.Tensor  # (B,) bool


class EnvDraws(NamedTuple):
  """Everything random one `step` may consume, one value per env (per
  frame, for a game with `per_frame_draws`)."""

  noops: torch.Tensor  # (B,) int in [1, max_noops] — noop burn length
  init: Any  # game init draws of a reset
  burn: Any  # game step draws for the noop burn of a reset
  step: Any  # game step draws for the action-repeat group


class VectorAtariEnv:
  """Batched game runner over B envs on one device."""

  def __init__(self, game: Game, batch_size: int,
               config: VectorEnvConfig = VectorEnvConfig(),
               device: torch.device | str | None = None):
    """`device` None runs on the card, as every entry point of the port
    does (`device.resolve_device`: raises where there is none); the CPU
    only when asked for."""
    self.game = game
    self.batch_size = batch_size
    self.config = config
    self.device = resolve_device(device)

  @property
  def num_actions(self) -> int:
    return self.game.num_actions

  def draws(self, gen: torch.Generator) -> EnvDraws:
    b, dev, cfg = self.batch_size, self.device, self.config
    noops = torch.randint(1, cfg.max_noops + 1, (b,), generator=gen,
                          device=dev)
    init = self.game.init_draws(gen, b, dev)
    if self.game.per_frame_draws:
      burn = self.game.step_draws(gen, b, dev, cfg.max_noops)
      step = self.game.step_draws(gen, b, dev, cfg.action_repeat)
    else:
      burn = self.game.step_draws(gen, b, dev)
      step = self.game.step_draws(gen, b, dev)
    return EnvDraws(noops=noops, init=init, burn=burn, step=step)

  def _frame_draws(self, draws, m: int):
    """The game draws of raw frame m of a group or a burn."""
    if not self.game.per_frame_draws:
      return draws
    return type(draws)(*(x[m] for x in draws))

  def init(self, gen: torch.Generator) -> VecEnvState:
    """All envs start in needs_reset, so the first step emits FIRST groups."""
    b, dev = self.batch_size, self.device
    return VecEnvState(
        game_state=self.game.init(self.game.init_draws(gen, b, dev)),
        episode_frames=torch.zeros((b,), dtype=torch.int32, device=dev),
        needs_reset=torch.ones((b,), dtype=torch.bool, device=dev),
    )

  def _reset(self, draws: EnvDraws):
    """`_reset_all`, on the card by the graph of this env's shapes. Its
    outputs are overwritten by the graph's next replay."""
    if self.device.type != "cuda":
      return self._reset_all(draws)
    key = (self.game, self.batch_size, self.config, self.device)
    graph = _RESET_GRAPHS.get(key)
    if graph is None:
      graph = _RESET_GRAPHS[key] = _ResetGraph(self, draws)
    return graph(draws)

  def _reset_all(self, draws: EnvDraws):
    """New episode states for every env after its 1..max_noops noop frames,
    with their frames and lives: the reset branch's device work.

    An episode that ends during the burn freezes at its last pre-done frame,
    as in the reference."""
    gs = self.game.init(draws.init)
    b = self.batch_size
    noop = torch.full((b,), self.config.noop_action, dtype=torch.int64,
                      device=self.device)
    done = torch.zeros((b,), dtype=torch.bool, device=self.device)
    for i in range(self.config.max_noops):
      active = draws.noops > i
      g2, _, d2, _ = self.game.step(gs, noop,
                                    self._frame_draws(draws.burn, i))
      keep = done | d2
      gs = tree_where(active & ~keep, g2, gs)
      done = torch.where(active, keep, done)
    return gs, self.game.render(gs), self.game.lives(gs)

  def step(self, state: VecEnvState, actions: torch.Tensor,
           draws: EnvDraws) -> Tuple[VecEnvState, GroupOutput]:
    """One agent-step (up to `action_repeat` raw frames) for all B envs.

    Functional: returns new tensors and leaves `state` as it was. Its
    spans: sync.reset (the read of whether any env needs a reset) and,
    where one does, env.reset_burn (the reset branch's device work, on the
    card its graph's replay), counted under env.reset_branch."""
    b, dev = self.batch_size, self.device
    zero_frame = torch.zeros((b, FRAME_HEIGHT, FRAME_WIDTH, 3),
                             dtype=torch.uint8, device=dev)
    fzero = torch.zeros((b,), dtype=torch.float32, device=dev)
    gs_c = state.game_state
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    reward = fzero
    life_disc = torch.ones((b,), dtype=torch.float32, device=dev)
    frames = torch.zeros((b,), dtype=torch.int32, device=dev)
    f_pen = f_last = zero_frame
    repeat = self.config.action_repeat
    for m in range(repeat):
      execute = ~done
      gs_n, r, d, ll = self.game.step(gs_c, actions,
                                      self._frame_draws(draws.step, m))
      gs_c = tree_where(execute, gs_n, gs_c)
      reward = reward + torch.where(execute, r, fzero)
      life_disc = life_disc * torch.where(execute & ll, 0.0, 1.0)
      frames = frames + execute.to(torch.int32)
      if m >= repeat - 2:
        shown = torch.where(execute[:, None, None, None],
                            self.game.render(gs_c), zero_frame)
        if m == repeat - 2:
          f_pen = shown
        else:
          f_last = shown
      done = done | (execute & d)

    ep = state.episode_frames + frames
    truncated = ~done & (ep >= self.config.episode_frame_cap)
    is_last = done | truncated
    discount = life_disc * torch.where(done, 0.0, 1.0)
    lives = self.game.lives(gs_c)
    reset = state.needs_reset
    false = torch.zeros_like(reset)
    if profiling.host_read(reset.any(), "reset"):
      with profiling.span("env.reset_burn"):
        gs_r, frame_r, lives_r = self._reset(draws)
      profiling.count("env.reset_branch")
      # The selects make new tensors: nothing returned aliases the graph's.
      col = reset[:, None, None, None]
      gs_c = tree_where(reset, gs_r, gs_c)
      f_pen = torch.where(col, zero_frame, f_pen)
      f_last = torch.where(col, frame_r, f_last)
      reward = torch.where(reset, fzero, reward)
      discount = torch.where(reset, 1.0, discount)
      is_last = torch.where(reset, false, is_last)
      truncated = torch.where(reset, false, truncated)
      frames = torch.where(reset, torch.ones_like(frames), frames)
      ep = torch.where(reset, torch.ones_like(ep), ep)
      lives = torch.where(reset, lives_r, lives)
    out = GroupOutput(
        frame_penult=f_pen,
        frame_last=f_last,
        reward_sum=reward,  # raw group sum; clipping happens in prep
        discount_prod=discount,
        is_first=reset.clone(),
        is_last=is_last,
        is_truncated=truncated,
        raw_reward_sum=reward,
        frames_used=frames,
        lives=lives,
    )
    return VecEnvState(gs_c, ep, is_last.clone()), out


def _tensors(draws: EnvDraws):
  """The tensors the reset branch reads: noops, init's, burn's (a game's
  draws may be None: it draws nothing there)."""
  return (draws.noops, *(draws.init or ()), *(draws.burn or ()))


def _clone(group):
  return None if group is None else type(group)(*(x.clone() for x in group))


# (game, batch size, VectorEnvConfig, device) -> its _ResetGraph: one
# capture a process, which the eval superstep's new env each call finds.
_RESET_GRAPHS: dict = {}


class _ResetGraph:
  """`env._reset_all` as one CUDA graph on static copies of the draws
  it reads. Made from the first reset's draws: a warm-up on a side stream
  (which fills the games' constant tables, whose copies from the host
  cannot be captured), then the capture, counted under
  env.reset_graph_capture. Each call copies its draws in and replays,
  counted under env.reset_graph."""

  def __init__(self, env: VectorAtariEnv, draws: EnvDraws):
    self.inputs = EnvDraws(noops=draws.noops.clone(),
                           init=_clone(draws.init), burn=_clone(draws.burn),
                           step=None)
    with torch.cuda.device(env.device):
      side = torch.cuda.Stream()
      side.wait_stream(torch.cuda.current_stream())
      with torch.cuda.stream(side):
        env._reset_all(self.inputs)
      torch.cuda.current_stream().wait_stream(side)
      self.graph = torch.cuda.CUDAGraph()
      # Thread-local: a call the capture forbids fails in this thread, and
      # other threads' calls (NCCL's watchdog querying its events, under
      # data parallelism) neither fail nor spoil the capture.
      with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
        self.outputs = env._reset_all(self.inputs)
    profiling.count("env.reset_graph_capture")

  def __call__(self, draws: EnvDraws):
    for dst, src in zip(_tensors(self.inputs), _tensors(draws)):
      dst.copy_(src)
    self.graph.replay()
    profiling.count("env.reset_graph")
    return self.outputs
