"""Demon Attack, batched (port of dqn_zoo_tpu/envs/games/demon_attack.py).

Same constants, update order, float expressions and colours as the
reference: three demons weave in their hover bands and drop bombs, a kill
pays 10 (wave + 1) and the demon respawns at a random column after a delay,
9 kills advance the wave, 4 lives, 6 actions. The reference splits a key
carried in the state at init (the cannon's and the demons' columns, the
demons' headings) and on every raw frame (a turn test, a respawn column and
a bomb test for each demon); here the state carries no key, `init` takes
`DemonAttackInitDraws` and `step` takes `DemonAttackStepDraws`, the draws
of one raw frame. The game declares `per_frame_draws`, so the vector env
hands each frame of a group and of the noop burn its own.

The wave's speed ramp takes the reference's compiled arithmetic
(`envs.f32`): one multiply-add.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from dqn_zoo_torch.envs import f32, render
from dqn_zoo_torch.envs.api import Game, register_game
from dqn_zoo_torch.envs.games import last_true

NUM_DEMONS = 3
DEMON_W, DEMON_H = 8, 8
DEMON_YS = (60.0, 90.0, 120.0)  # hover bands (top of each demon)
LEFT, RIGHT = 8.0, 152.0
PLAYER_Y = 180
PLAYER_W, PLAYER_H = 10, 8
PLAYER_SPEED = 3.0
SHOT_W, SHOT_SPEED = 2, 8.0
BOMB_W, BOMB_H, BOMB_SPEED = 2, 6, 3.0
BOMB_PROB = 0.022  # per demon per frame
FLIP_PROB = 0.02  # a demon turns at random with this probability a frame
LIVES = 4
RESPAWN_FRAMES = 40  # demon respawn delay after a kill
HIT_PAUSE = 30  # player invulnerability after losing a life
KILLS_PER_WAVE = 9
BASE_POINTS = 10.0  # a kill in wave w pays (w + 1) * 10


class DemonAttackState(NamedTuple):
  player_x: torch.Tensor  # (B,) f32 left edge
  demon_x: torch.Tensor  # (B, N) f32
  demon_dir: torch.Tensor  # (B, N) f32 ±1 weave direction
  demon_live: torch.Tensor  # (B, N) bool
  demon_delay: torch.Tensor  # (B, N) i32 respawn countdown of dead demons
  shot_x: torch.Tensor  # (B,) f32
  shot_y: torch.Tensor  # (B,) f32
  shot_live: torch.Tensor  # (B,) bool
  bomb_x: torch.Tensor  # (B, N) f32
  bomb_y: torch.Tensor  # (B, N) f32
  bomb_live: torch.Tensor  # (B, N) bool
  lives: torch.Tensor  # (B,) i32
  wave: torch.Tensor  # (B,) i32
  kills: torch.Tensor  # (B,) i32 kills this wave
  hit_pause: torch.Tensor  # (B,) i32


class DemonAttackInitDraws(NamedTuple):
  player_x: torch.Tensor  # (B,) f32 in [LEFT, RIGHT - PLAYER_W)
  demon_x: torch.Tensor  # (B, N) f32 in [LEFT, RIGHT - DEMON_W)
  demon_right: torch.Tensor  # (B, N) bool, the demon heads right


class DemonAttackStepDraws(NamedTuple):
  flip_u: torch.Tensor  # (B, N) U[0, 1): a demon turns where < 0.02
  spawn_x: torch.Tensor  # (B, N) f32 in [LEFT, RIGHT - DEMON_W), respawns
  bomb_u: torch.Tensor  # (B, N) U[0, 1): a demon bombs where < 0.022


def _columns(gen, shape, device, width):
  u = torch.rand(shape, generator=gen, device=device)
  return u * (RIGHT - width - LEFT) + LEFT


def demon_attack_init_draws(gen, b, device) -> DemonAttackInitDraws:
  return DemonAttackInitDraws(
      player_x=_columns(gen, (b,), device, PLAYER_W),
      demon_x=_columns(gen, (b, NUM_DEMONS), device, DEMON_W),
      demon_right=torch.rand((b, NUM_DEMONS), generator=gen,
                             device=device) < 0.5)


def demon_attack_step_draws(gen, b, device,
                            frames: int) -> DemonAttackStepDraws:
  """The demon draws of `frames` raw frames: (frames, B, N) each."""
  shape = (frames, b, NUM_DEMONS)
  return DemonAttackStepDraws(
      flip_u=torch.rand(shape, generator=gen, device=device),
      spawn_x=_columns(gen, shape, device, DEMON_W),
      bomb_u=torch.rand(shape, generator=gen, device=device))


def demon_attack_init(draws: DemonAttackInitDraws) -> DemonAttackState:
  b = draws.player_x.shape[0]
  dev = draws.player_x.device
  f = lambda v, *s: torch.full((b,) + s, v, dtype=torch.float32, device=dev)
  i = lambda v, *s: torch.full((b,) + s, v, dtype=torch.int32, device=dev)
  no = lambda: torch.zeros((b, NUM_DEMONS), dtype=torch.bool, device=dev)
  return DemonAttackState(
      player_x=draws.player_x.to(torch.float32),
      demon_x=draws.demon_x.to(torch.float32),
      demon_dir=torch.where(draws.demon_right, 1.0, f(-1.0, NUM_DEMONS)),
      demon_live=~no(),
      demon_delay=i(0, NUM_DEMONS),
      shot_x=f(0.0),
      shot_y=f(0.0),
      shot_live=torch.zeros((b,), dtype=torch.bool, device=dev),
      bomb_x=f(0.0, NUM_DEMONS),
      bomb_y=f(0.0, NUM_DEMONS),
      bomb_live=no(),
      lives=i(LIVES),
      wave=i(0),
      kills=i(0),
      hit_pause=i(0),
  )


class _Tables(NamedTuple):
  demon_y: torch.Tensor  # (1, N) f32
  ice: torch.Tensor  # (210, 160) bool


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> _Tables:
  """The step's and the render's constant tensors on `device`, copied there
  once."""
  return _Tables(
      demon_y=torch.tensor(DEMON_YS, dtype=torch.float32,
                           device=device)[None, :],
      ice=render.rect_mask(190, 210, 0, 160, device))


def demon_attack_step(state: DemonAttackState, action: torch.Tensor,
                      draws: DemonAttackStepDraws):
  c = _tables(state.player_x.device)
  right = (action == 2) | (action == 4)
  left = (action == 3) | (action == 5)
  fire = (action == 1) | (action == 4) | (action == 5)
  zero = torch.zeros_like(state.player_x)
  dx = torch.where(right, PLAYER_SPEED,
                   torch.where(left, -PLAYER_SPEED, zero))
  player_x = torch.clamp(state.player_x + dx, LEFT, RIGHT - PLAYER_W)

  # Demons weave horizontally, faster each wave (1.2 + 0.3 wave, one
  # multiply-add); a dead demon counts down its respawn delay and re-enters
  # at a random column.
  speed = f32.fma(state.wave.to(torch.float32), 0.3, 1.2)
  demon_x = state.demon_x + state.demon_dir * speed[:, None] * state.demon_live
  at_edge = (demon_x < LEFT) | (demon_x > RIGHT - DEMON_W)
  rand_flip = draws.flip_u < FLIP_PROB
  demon_dir = torch.where(at_edge | rand_flip, -state.demon_dir,
                          state.demon_dir)
  demon_x = torch.clamp(demon_x, LEFT, RIGHT - DEMON_W)
  demon_delay = torch.clamp(state.demon_delay - 1, min=0)
  respawn = ~state.demon_live & (demon_delay == 0)
  demon_x = torch.where(respawn, draws.spawn_x.to(torch.float32), demon_x)
  demon_live = state.demon_live | respawn

  # The player's shot (one on screen).
  do_fire = fire & ~state.shot_live
  shot_x = torch.where(do_fire, player_x + PLAYER_W / 2, state.shot_x)
  shot_y = torch.where(do_fire, float(PLAYER_Y) - 2.0, state.shot_y)
  shot_live = state.shot_live | do_fire
  shot_y = shot_y - torch.where(shot_live, SHOT_SPEED, zero)
  shot_live = shot_live & (shot_y > 40.0)

  # Shot <-> demons; one shot kills one demon, the lowest band hit.
  demon_y = c.demon_y
  sx, sy = shot_x[:, None], shot_y[:, None]
  hit = (shot_live[:, None] & demon_live
         & (sx + SHOT_W >= demon_x) & (sx <= demon_x + DEMON_W)
         & (sy <= demon_y + DEMON_H) & (sy + 6.0 >= demon_y))
  any_hit = hit.any(dim=1)
  kill = last_true(hit)
  demon_live = demon_live & ~kill
  demon_delay = torch.where(kill, RESPAWN_FRAMES, demon_delay)
  shot_live = shot_live & ~any_hit
  reward = torch.where(any_hit,
                       BASE_POINTS * (state.wave + 1).to(torch.float32),
                       zero)
  kills = state.kills + any_hit.to(torch.int32)

  # Bombs: each live demon may drop one (one in flight per demon).
  do_bomb = demon_live & ~state.bomb_live & (draws.bomb_u < BOMB_PROB)
  bomb_x = torch.where(do_bomb, demon_x + DEMON_W / 2, state.bomb_x)
  bomb_y = torch.where(do_bomb, demon_y + DEMON_H, state.bomb_y)
  bomb_live = state.bomb_live | do_bomb
  bomb_y = bomb_y + torch.where(bomb_live, BOMB_SPEED, 0.0)
  bomb_live = bomb_live & (bomb_y < 200.0)

  # Bomb <-> player (not during the pause after a hit).
  vulnerable = state.hit_pause <= 0
  hit_pause = torch.clamp(state.hit_pause - 1, min=0)
  px = player_x[:, None]
  overlap = (bomb_live
             & (bomb_x + BOMB_W >= px) & (bomb_x <= px + PLAYER_W)
             & (bomb_y + BOMB_H >= PLAYER_Y)
             & (bomb_y <= PLAYER_Y + PLAYER_H))
  player_hit = overlap.any(dim=1) & vulnerable
  bomb_live = bomb_live & ~player_hit[:, None]
  lives = state.lives - player_hit.to(torch.int32)
  hit_pause = torch.where(player_hit, HIT_PAUSE, hit_pause)

  # Enough kills advance the wave: a higher bounty, faster demons.
  next_wave = kills >= KILLS_PER_WAVE
  wave = state.wave + next_wave.to(torch.int32)
  kills = torch.where(next_wave, 0, kills)

  done = lives <= 0
  new_state = DemonAttackState(
      player_x, demon_x, demon_dir, demon_live, demon_delay,
      shot_x, shot_y, shot_live, bomb_x, bomb_y, bomb_live,
      lives, wave, kills, hit_pause)
  life_lost = player_hit & ~done
  return new_state, reward, done, life_lost


def demon_attack_render(state: DemonAttackState) -> torch.Tensor:
  b = state.player_x.shape[0]
  dev = state.player_x.device
  c = _tables(dev)
  rect = lambda *box: render.rect_mask(*box, dev)
  demons = torch.zeros((b, 210, 160), dtype=torch.bool, device=dev)
  bombs = torch.zeros((b, 210, 160), dtype=torch.bool, device=dev)
  for i, top in enumerate(DEMON_YS):
    x = state.demon_x[:, i]
    demons = demons | (rect(int(top), int(top) + DEMON_H, x, x + DEMON_W)
                       & state.demon_live[:, i, None, None])
  for i in range(NUM_DEMONS):
    y, x = state.bomb_y[:, i], state.bomb_x[:, i]
    bombs = bombs | (rect(y, y + BOMB_H, x, x + BOMB_W)
                     & state.bomb_live[:, i, None, None])
  shot = rect(state.shot_y, state.shot_y + 6, state.shot_x,
              state.shot_x + SHOT_W) & state.shot_live[:, None, None]
  player = rect(PLAYER_Y, PLAYER_Y + PLAYER_H, state.player_x,
                state.player_x + PLAYER_W)
  return render.compose(
      b, dev, (0, 0, 0),
      (c.ice, (84, 92, 214)),
      (demons, (228, 111, 111)),
      (bombs, (236, 140, 30)),
      (shot, (236, 236, 236)),
      (player, (184, 70, 162)),
  )


def demon_attack_lives(state: DemonAttackState) -> torch.Tensor:
  return state.lives


GAME = register_game(Game(
    name="demon_attack",
    num_actions=6,
    init=demon_attack_init,
    step=demon_attack_step,
    render=demon_attack_render,
    lives=demon_attack_lives,
    init_draws=demon_attack_init_draws,
    step_draws=demon_attack_step_draws,
    per_frame_draws=True,
))
