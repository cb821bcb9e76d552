"""Phoenix, batched (port of dqn_zoo_tpu/envs/games/phoenix.py).

Same constants, update order, float expressions and colours as the
reference: eight birds weave in two ranks and dive at the ship, DOWN raises
a shield that destroys a diver for a bonus, a shot bird pays by its rank
(40 diving), a cleared flock starts the next wave, 5 lives, 8 actions. The
reference splits a key carried in the state at init (the ship's and the
birds' columns, the birds' headings) and on every raw frame (a turn test, a
dive test and a respawn column for each bird); here the state carries no
key, `init` takes `PhoenixInitDraws` and `step` takes `PhoenixStepDraws`,
the draws of one raw frame. The game declares `per_frame_draws`, so the
vector env hands each frame of a group and of the noop burn its own.

The wave's speed ramp takes the reference's compiled arithmetic
(`envs.f32`): one multiply-add; the shield's right edge is XLA's folded
`x + 12`.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from dqn_zoo_torch.envs import f32, render
from dqn_zoo_torch.envs.api import Game, register_game
from dqn_zoo_torch.envs.games import last_true

NUM_BIRDS = 8  # two ranks of four
BIRD_W, BIRD_H = 8, 6
RANK_YS = (56.0, 76.0)  # hover rows (top edge) of ranks 0 and 1
LEFT, RIGHT = 8.0, 152.0
PLAYER_Y = 180
PLAYER_W, PLAYER_H = 10, 8
PLAYER_SPEED = 3.0
SHOT_W, SHOT_SPEED = 2, 7.0
DIVE_PROB = 0.012  # per bird per frame, the chance to start a dive
FLIP_PROB = 0.03  # a bird turns at random with this probability a frame
DIVE_SPEED = 3.2
LIVES = 5
RESPAWN_FRAMES = 45
HIT_PAUSE = 30
SHIELD_FRAMES = 24  # the shield stays up this long once raised
SHIELD_COOLDOWN = 40
POINTS = (25.0, 12.0)  # per rank (the upper rank pays more)
DIVER_BONUS = 40.0  # a shield kill, or shooting a diving bird
RANK_Y = (RANK_YS[0],) * 4 + (RANK_YS[1],) * 4
RANK_POINTS = (POINTS[0],) * 4 + (POINTS[1],) * 4


class PhoenixState(NamedTuple):
  player_x: torch.Tensor  # (B,) f32 left edge
  bird_x: torch.Tensor  # (B, N) f32
  bird_y: torch.Tensor  # (B, N) f32 (hover row or diving position)
  bird_dir: torch.Tensor  # (B, N) f32 ±1 weave direction
  bird_live: torch.Tensor  # (B, N) bool
  bird_diving: torch.Tensor  # (B, N) bool
  bird_delay: torch.Tensor  # (B, N) i32 respawn countdown
  shot_x: torch.Tensor  # (B,) f32
  shot_y: torch.Tensor  # (B,) f32
  shot_live: torch.Tensor  # (B,) bool
  shield: torch.Tensor  # (B,) i32 frames of shield remaining
  shield_cd: torch.Tensor  # (B,) i32 frames until it can be raised again
  lives: torch.Tensor  # (B,) i32
  wave: torch.Tensor  # (B,) i32
  hit_pause: torch.Tensor  # (B,) i32


class PhoenixInitDraws(NamedTuple):
  player_x: torch.Tensor  # (B,) f32 in [LEFT, RIGHT - PLAYER_W)
  bird_x: torch.Tensor  # (B, N) f32 in [LEFT, RIGHT - BIRD_W)
  bird_right: torch.Tensor  # (B, N) bool, the bird heads right


class PhoenixStepDraws(NamedTuple):
  flip_u: torch.Tensor  # (B, N) U[0, 1): a bird turns where < 0.03
  dive_u: torch.Tensor  # (B, N) U[0, 1): a bird dives where < 0.012
  spawn_x: torch.Tensor  # (B, N) f32 in [LEFT, RIGHT - BIRD_W), respawns


def _columns(gen, shape, device, width):
  u = torch.rand(shape, generator=gen, device=device)
  return u * (RIGHT - width - LEFT) + LEFT


def phoenix_init_draws(gen, b, device) -> PhoenixInitDraws:
  return PhoenixInitDraws(
      player_x=_columns(gen, (b,), device, PLAYER_W),
      bird_x=_columns(gen, (b, NUM_BIRDS), device, BIRD_W),
      bird_right=torch.rand((b, NUM_BIRDS), generator=gen,
                            device=device) < 0.5)


def phoenix_step_draws(gen, b, device, frames: int) -> PhoenixStepDraws:
  """The bird draws of `frames` raw frames: (frames, B, N) each."""
  shape = (frames, b, NUM_BIRDS)
  return PhoenixStepDraws(
      flip_u=torch.rand(shape, generator=gen, device=device),
      dive_u=torch.rand(shape, generator=gen, device=device),
      spawn_x=_columns(gen, shape, device, BIRD_W))


class _Tables(NamedTuple):
  rank_y: torch.Tensor  # (1, N) f32
  rank_points: torch.Tensor  # (1, N) f32
  stars: torch.Tensor  # (210, 160) bool


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> _Tables:
  """The step's and the render's constant tensors on `device`, copied there
  once."""
  row = lambda v: torch.tensor(v, dtype=torch.float32, device=device)[None]
  return _Tables(rank_y=row(RANK_Y), rank_points=row(RANK_POINTS),
                 stars=render.rect_mask(40, 42, 0, 160, device))


def phoenix_init(draws: PhoenixInitDraws) -> PhoenixState:
  b = draws.player_x.shape[0]
  dev = draws.player_x.device
  f = lambda v: torch.full((b,), v, dtype=torch.float32, device=dev)
  i = lambda v, *s: torch.full((b,) + s, v, dtype=torch.int32, device=dev)
  no = lambda *s: torch.zeros((b,) + s, dtype=torch.bool, device=dev)
  return PhoenixState(
      player_x=draws.player_x.to(torch.float32),
      bird_x=draws.bird_x.to(torch.float32),
      bird_y=_tables(dev).rank_y.expand(b, NUM_BIRDS).clone(),
      bird_dir=torch.where(draws.bird_right, 1.0, -1.0).to(torch.float32),
      bird_live=~no(NUM_BIRDS),
      bird_diving=no(NUM_BIRDS),
      bird_delay=i(0, NUM_BIRDS),
      shot_x=f(0.0),
      shot_y=f(0.0),
      shot_live=no(),
      shield=i(0),
      shield_cd=i(0),
      lives=i(LIVES),
      wave=i(0),
      hit_pause=i(0),
  )


def phoenix_step(state: PhoenixState, action: torch.Tensor,
                 draws: PhoenixStepDraws):
  c = _tables(state.player_x.device)
  right = (action == 2) | (action == 5)
  left = (action == 3) | (action == 6)
  fire = (action == 1) | (action == 5) | (action == 6) | (action == 7)
  shield_btn = (action == 4) | (action == 7)
  zero = torch.zeros_like(state.player_x)
  dx = torch.where(right, PLAYER_SPEED,
                   torch.where(left, -PLAYER_SPEED, zero))
  player_x = torch.clamp(state.player_x + dx, LEFT, RIGHT - PLAYER_W)

  # The shield: DOWN raises it when it is off and cooled down; it runs
  # down, then cools.
  raise_shield = shield_btn & (state.shield_cd <= 0) & (state.shield <= 0)
  shield = torch.where(raise_shield, SHIELD_FRAMES,
                       torch.clamp(state.shield - 1, min=0))
  shield_cd = torch.where(raise_shield, SHIELD_COOLDOWN,
                          torch.clamp(state.shield_cd - 1, min=0))
  shield_up = shield > 0

  # Birds weave at their rank, faster each wave (1 + 0.25 wave, one
  # multiply-add); divers home on the ship.
  speed = f32.fma(state.wave.to(torch.float32), 0.25, 1.0)
  weave_x = state.bird_x + state.bird_dir * speed[:, None]
  at_edge = (weave_x < LEFT) | (weave_x > RIGHT - BIRD_W)
  rand_flip = draws.flip_u < FLIP_PROB
  bird_dir = torch.where(at_edge | rand_flip, -state.bird_dir,
                         state.bird_dir)
  weave_x = torch.clamp(weave_x, LEFT, RIGHT - BIRD_W)

  start_dive = (state.bird_live & ~state.bird_diving
                & (draws.dive_u < DIVE_PROB))
  diving = (state.bird_diving | start_dive) & state.bird_live
  # Divers descend and steer toward the ship's column.
  steer = torch.clamp(player_x[:, None] - state.bird_x, -2.0, 2.0)
  dive_x = torch.clamp(state.bird_x + steer, LEFT, RIGHT - BIRD_W)
  dive_y = state.bird_y + DIVE_SPEED
  bird_x = torch.where(diving, dive_x, weave_x)
  bird_y = torch.where(diving, dive_y, c.rank_y)
  # A diver that overflies the ship's row returns to its rank.
  returned = diving & (bird_y > 200.0)
  diving = diving & ~returned
  bird_y = torch.where(returned, c.rank_y, bird_y)

  # Respawns.
  bird_delay = torch.clamp(state.bird_delay - 1, min=0)
  respawn = ~state.bird_live & (bird_delay == 0)
  bird_x = torch.where(respawn, draws.spawn_x.to(torch.float32), bird_x)
  bird_y = torch.where(respawn, c.rank_y, bird_y)
  bird_live = state.bird_live | respawn

  # The ship's shot.
  do_fire = fire & ~state.shot_live
  shot_x = torch.where(do_fire, player_x + PLAYER_W / 2, state.shot_x)
  shot_y = torch.where(do_fire, float(PLAYER_Y) - 2.0, state.shot_y)
  shot_live = state.shot_live | do_fire
  shot_y = shot_y - torch.where(shot_live, SHOT_SPEED, zero)
  shot_live = shot_live & (shot_y > 40.0)

  # Shot <-> birds; one shot kills one bird, the lowest index hit last.
  sx, sy = shot_x[:, None], shot_y[:, None]
  hit = (shot_live[:, None] & bird_live
         & (sx + SHOT_W >= bird_x) & (sx <= bird_x + BIRD_W)
         & (sy <= bird_y + BIRD_H) & (sy + 6.0 >= bird_y))
  any_hit = hit.any(dim=1)
  kill = last_true(hit)
  shot_live = shot_live & ~any_hit
  zeros = torch.zeros_like(bird_x)
  shot_reward = torch.where(
      kill, torch.where(diving, DIVER_BONUS, c.rank_points), zeros).sum(1)

  # Diver <-> ship: the shield kills the diver (a bonus), else a life.
  vulnerable = state.hit_pause <= 0
  hit_pause = torch.clamp(state.hit_pause - 1, min=0)
  px = player_x[:, None]
  contact = (diving & bird_live
             & (bird_x + BIRD_W >= px) & (bird_x <= px + PLAYER_W)
             & (bird_y + BIRD_H >= PLAYER_Y)
             & (bird_y <= PLAYER_Y + PLAYER_H))
  shield_kill = contact & shield_up[:, None]
  crash = contact.any(dim=1) & ~shield_up & vulnerable
  killed = kill | shield_kill
  bird_live = bird_live & ~killed
  diving = diving & ~killed
  bird_delay = torch.where(killed, RESPAWN_FRAMES, bird_delay)
  reward = shot_reward + torch.where(shield_kill, DIVER_BONUS,
                                     zeros).sum(1)
  lives = state.lives - crash.to(torch.int32)
  hit_pause = torch.where(crash, HIT_PAUSE, hit_pause)

  # A cleared flock (every bird waiting to respawn) starts the next wave.
  cleared = ~bird_live.any(dim=1)
  wave = state.wave + cleared.to(torch.int32)

  done = lives <= 0
  new_state = PhoenixState(
      player_x, bird_x, bird_y, bird_dir, bird_live, diving, bird_delay,
      shot_x, shot_y, shot_live, shield, shield_cd, lives, wave, hit_pause)
  life_lost = crash & ~done
  return new_state, reward, done, life_lost


def phoenix_render(state: PhoenixState) -> torch.Tensor:
  b = state.player_x.shape[0]
  dev = state.player_x.device
  rect = lambda *box: render.rect_mask(*box, dev)
  # Every bird's box at once, (B, N, 210, 160), then their union.
  y, x = state.bird_y, state.bird_x
  birds = (rect(y, y + BIRD_H, x, x + BIRD_W)
           & state.bird_live[:, :, None, None]).any(dim=1)
  shot = rect(state.shot_y, state.shot_y + 6, state.shot_x,
              state.shot_x + SHOT_W) & state.shot_live[:, None, None]
  px = state.player_x
  player = rect(PLAYER_Y, PLAYER_Y + PLAYER_H, px, px + PLAYER_W)
  shield = rect(PLAYER_Y - 6, PLAYER_Y - 2, px - 2, px + (PLAYER_W + 2)) \
      & (state.shield > 0)[:, None, None]
  return render.compose(
      b, dev, (0, 0, 0),
      (_tables(dev).stars, (52, 52, 94)),
      (birds, (212, 160, 56)),
      (shot, (236, 236, 236)),
      (shield, (110, 190, 230)),
      (player, (80, 160, 220)),
  )


def phoenix_lives(state: PhoenixState) -> torch.Tensor:
  return state.lives


GAME = register_game(Game(
    name="phoenix",
    num_actions=8,
    init=phoenix_init,
    step=phoenix_step,
    render=phoenix_render,
    lives=phoenix_lives,
    init_draws=phoenix_init_draws,
    step_draws=phoenix_step_draws,
    per_frame_draws=True,
))
