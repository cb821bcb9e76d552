"""Assault, batched (port of dqn_zoo_tpu/envs/games/assault.py).

Same constants, update order, float expressions and colours as the
reference: a mothership deploys up to three drones that strafe, sink and
bomb; the turret overheats if fired too often; 21 a drone, 150 for downing
the mothership, 4 lives, 7 actions. The reference splits a key carried in
the state at init (the turret's column, the mothership's heading) and on
every raw frame (a turn test and a bomb test for each drone); here the
state carries no key, `init` takes `AssaultInitDraws` and `step` takes
`AssaultStepDraws`, the draws of one raw frame. The game declares
`per_frame_draws`, so the vector env hands each frame of a group and of the
noop burn its own.

The wave's speed ramps and the heat bar take the reference's compiled
arithmetic (`envs.f32`): XLA fuses a product that feeds a sum into one
multiply-add.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from dqn_zoo_torch.envs import f32, render
from dqn_zoo_torch.envs.api import Game, constant, register_game
from dqn_zoo_torch.envs.games import last_true

NUM_DRONES = 3
DRONE_W, DRONE_H = 14, 7
LEFT, RIGHT = 8.0, 152.0
MOTHER_Y, MOTHER_W, MOTHER_H = 42.0, 24, 8
PLAYER_Y = 180
PLAYER_W, PLAYER_H = 10, 8
PLAYER_SPEED = 3.0
SHOT_W, SHOT_SPEED = 2, 7.0
BOMB_W, BOMB_H, BOMB_SPEED = 2, 6, 2.8
BOMB_PROB = 0.012
FLIP_PROB = 0.02  # a drone turns at random with this probability a frame
DRONE_DROP = 0.55  # px/frame descent
LIVES = 4
SPAWN_DELAY = 50
HIT_PAUSE = 30
HEAT_PER_SHOT = 25
HEAT_MAX = 100
COOL_PER_FRAME = 1
DRONE_POINTS = 21.0
MOTHER_POINTS = 150.0
MOTHER_HITS = 6  # hits to down the mothership
DEPLOY_DELAYS = (10, 60, 110)


class AssaultState(NamedTuple):
  player_x: torch.Tensor  # (B,) f32 left edge
  mother_x: torch.Tensor  # (B,) f32
  mother_dir: torch.Tensor  # (B,) f32 ±1
  mother_hp: torch.Tensor  # (B,) i32 hits left
  drone_x: torch.Tensor  # (B, N) f32
  drone_y: torch.Tensor  # (B, N) f32
  drone_dir: torch.Tensor  # (B, N) f32
  drone_live: torch.Tensor  # (B, N) bool
  drone_delay: torch.Tensor  # (B, N) i32 deploy countdown
  shot_x: torch.Tensor  # (B,) f32
  shot_y: torch.Tensor  # (B,) f32
  shot_live: torch.Tensor  # (B,) bool
  bomb_x: torch.Tensor  # (B, N) f32
  bomb_y: torch.Tensor  # (B, N) f32
  bomb_live: torch.Tensor  # (B, N) bool
  heat: torch.Tensor  # (B,) i32
  lives: torch.Tensor  # (B,) i32
  wave: torch.Tensor  # (B,) i32
  hit_pause: torch.Tensor  # (B,) i32


class AssaultInitDraws(NamedTuple):
  player_x: torch.Tensor  # (B,) f32 in [LEFT, RIGHT - PLAYER_W)
  mother_right: torch.Tensor  # (B,) bool, the mothership heads right


class AssaultStepDraws(NamedTuple):
  flip_u: torch.Tensor  # (B, N) U[0, 1): a drone turns where < 0.02
  bomb_u: torch.Tensor  # (B, N) U[0, 1): a drone bombs where < 0.012


def assault_init_draws(gen, b, device) -> AssaultInitDraws:
  u = torch.rand((b,), generator=gen, device=device)
  return AssaultInitDraws(
      player_x=u * (RIGHT - PLAYER_W - LEFT) + LEFT,
      mother_right=torch.rand((b,), generator=gen, device=device) < 0.5)


def assault_step_draws(gen, b, device, frames: int) -> AssaultStepDraws:
  """The drone draws of `frames` raw frames: (frames, B, N) each."""
  shape = (frames, b, NUM_DRONES)
  return AssaultStepDraws(
      flip_u=torch.rand(shape, generator=gen, device=device),
      bomb_u=torch.rand(shape, generator=gen, device=device))


def assault_init(draws: AssaultInitDraws) -> AssaultState:
  b = draws.player_x.shape[0]
  dev = draws.player_x.device
  f = lambda v, *s: torch.full((b,) + s, v, dtype=torch.float32, device=dev)
  i = lambda v: torch.full((b,), v, dtype=torch.int32, device=dev)
  no = lambda: torch.zeros((b, NUM_DRONES), dtype=torch.bool, device=dev)
  return AssaultState(
      player_x=draws.player_x.to(torch.float32),
      mother_x=f(70.0),
      mother_dir=torch.where(draws.mother_right, 1.0, f(-1.0)),
      mother_hp=i(MOTHER_HITS),
      drone_x=f(0.0, NUM_DRONES),
      drone_y=f(0.0, NUM_DRONES),
      drone_dir=f(1.0, NUM_DRONES),
      drone_live=no(),
      drone_delay=constant(DEPLOY_DELAYS, torch.int32,
                           dev).expand(b, -1).clone(),
      shot_x=f(0.0),
      shot_y=f(0.0),
      shot_live=torch.zeros((b,), dtype=torch.bool, device=dev),
      bomb_x=f(0.0, NUM_DRONES),
      bomb_y=f(0.0, NUM_DRONES),
      bomb_live=no(),
      heat=i(0),
      lives=i(LIVES),
      wave=i(0),
      hit_pause=i(0),
  )


@functools.lru_cache(maxsize=None)
def _ground(device: torch.device) -> torch.Tensor:
  """The render's one constant mask on `device`, copied there once."""
  return render.rect_mask(192, 196, 0, 160, device)


def assault_step(state: AssaultState, action: torch.Tensor,
                 draws: AssaultStepDraws):
  right = (action == 3) | (action == 5)
  left = (action == 4) | (action == 6)
  fire = (action == 1) | (action == 2) | (action == 5) | (action == 6)
  zero = torch.zeros_like(state.player_x)
  dx = torch.where(right, PLAYER_SPEED,
                   torch.where(left, -PLAYER_SPEED, zero))
  player_x = torch.clamp(state.player_x + dx, LEFT, RIGHT - PLAYER_W)
  wave_f = state.wave.to(torch.float32)

  # The mothership tracks slowly above the field; its speed 0.8 + 0.2 wave
  # is one multiply-add.
  mother_x = state.mother_x + state.mother_dir * f32.fma(wave_f, 0.2, 0.8)
  m_edge = (mother_x < LEFT) | (mother_x > RIGHT - MOTHER_W)
  mother_dir = torch.where(m_edge, -state.mother_dir, state.mother_dir)
  mother_x = torch.clamp(mother_x, LEFT, RIGHT - MOTHER_W)

  # Drones deploy from the mothership after their delay, then strafe and
  # sink toward the turret row.
  drone_delay = torch.clamp(state.drone_delay - 1, min=0)
  deploy = ~state.drone_live & (drone_delay == 0)
  drone_x = torch.where(deploy, (mother_x + MOTHER_W / 2)[:, None],
                        state.drone_x)
  drone_y = torch.where(deploy, MOTHER_Y + MOTHER_H + 2.0, state.drone_y)
  drone_live = state.drone_live | deploy
  speed = f32.fma(wave_f, 0.3, 1.4)
  drone_x = drone_x + state.drone_dir * speed[:, None] * drone_live
  d_edge = (drone_x < LEFT) | (drone_x > RIGHT - DRONE_W)
  rand_flip = draws.flip_u < FLIP_PROB
  drone_dir = torch.where(d_edge | rand_flip, -state.drone_dir,
                          state.drone_dir)
  drone_x = torch.clamp(drone_x, LEFT, RIGHT - DRONE_W)
  drone_y = drone_y + torch.where(drone_live, DRONE_DROP, 0.0)
  drone_y = torch.clamp(drone_y, max=float(PLAYER_Y) - DRONE_H - 2.0)

  # Turret shot and heat: firing adds heat, idling cools it.
  do_fire = fire & ~state.shot_live & (state.hit_pause <= 0)
  shot_x = torch.where(do_fire, player_x + PLAYER_W / 2, state.shot_x)
  shot_y = torch.where(do_fire, float(PLAYER_Y) - 2.0, state.shot_y)
  shot_live = state.shot_live | do_fire
  shot_y = shot_y - torch.where(shot_live, SHOT_SPEED, zero)
  shot_live = shot_live & (shot_y > MOTHER_Y - 4.0)
  heat = (torch.clamp(state.heat - COOL_PER_FRAME, min=0)
          + torch.where(do_fire, HEAT_PER_SHOT, 0))
  overheat = heat >= HEAT_MAX
  heat = torch.where(overheat, 0, heat).to(torch.int32)

  # Shot <-> drones: one kill a shot, the last drone hit.
  sx, sy = shot_x[:, None], shot_y[:, None]
  hit = (shot_live[:, None] & drone_live
         & (sx + SHOT_W >= drone_x) & (sx <= drone_x + DRONE_W)
         & (sy <= drone_y + DRONE_H) & (sy + 6.0 >= drone_y))
  any_hit = hit.any(dim=1)
  kill = last_true(hit)
  drone_live = drone_live & ~kill
  drone_delay = torch.where(kill, SPAWN_DELAY, drone_delay)
  reward = torch.where(any_hit, DRONE_POINTS, zero)
  shot_live = shot_live & ~any_hit

  # Shot <-> mothership (only when no drone took the shot).
  m_hit = (shot_live
           & (shot_x + SHOT_W >= mother_x) & (shot_x <= mother_x + MOTHER_W)
           & (shot_y <= MOTHER_Y + MOTHER_H) & (shot_y + 6.0 >= MOTHER_Y))
  mother_hp = state.mother_hp - m_hit.to(torch.int32)
  shot_live = shot_live & ~m_hit
  downed = mother_hp <= 0
  reward = reward + torch.where(downed, MOTHER_POINTS, zero)
  wave = state.wave + downed.to(torch.int32)
  mother_hp = torch.where(downed, MOTHER_HITS, mother_hp)

  # Drone bombs.
  do_bomb = drone_live & ~state.bomb_live & (draws.bomb_u < BOMB_PROB)
  bomb_x = torch.where(do_bomb, drone_x + DRONE_W / 2, state.bomb_x)
  bomb_y = torch.where(do_bomb, drone_y + DRONE_H, state.bomb_y)
  bomb_live = state.bomb_live | do_bomb
  bomb_y = bomb_y + torch.where(bomb_live, BOMB_SPEED, 0.0)
  bomb_live = bomb_live & (bomb_y < 200.0)

  # Bomb <-> turret, and a drone's body at turret height.
  vulnerable = state.hit_pause <= 0
  hit_pause = torch.clamp(state.hit_pause - 1, min=0)
  px = player_x[:, None]
  bombed = (bomb_live
            & (bomb_x + BOMB_W >= px) & (bomb_x <= px + PLAYER_W)
            & (bomb_y + BOMB_H >= PLAYER_Y)
            & (bomb_y <= PLAYER_Y + PLAYER_H))
  rammed = (drone_live
            & (drone_x + DRONE_W >= px)
            & (drone_x <= px + PLAYER_W)
            & (drone_y + DRONE_H >= PLAYER_Y - 2.0))
  destroyed = ((bombed.any(dim=1) | rammed.any(dim=1) | overheat)
               & vulnerable)
  bomb_live = bomb_live & ~destroyed[:, None]
  lives = state.lives - destroyed.to(torch.int32)
  hit_pause = torch.where(destroyed, HIT_PAUSE, hit_pause)

  done = lives <= 0
  new_state = AssaultState(
      player_x, mother_x, mother_dir, mother_hp, drone_x, drone_y,
      drone_dir, drone_live, drone_delay, shot_x, shot_y, shot_live,
      bomb_x, bomb_y, bomb_live, heat, lives, wave, hit_pause)
  life_lost = destroyed & ~done
  return new_state, reward, done, life_lost


def assault_render(state: AssaultState) -> torch.Tensor:
  b = state.player_x.shape[0]
  dev = state.player_x.device
  rect = lambda *box: render.rect_mask(*box, dev)
  mother = rect(int(MOTHER_Y), int(MOTHER_Y) + MOTHER_H, state.mother_x,
                state.mother_x + MOTHER_W)
  drones = torch.zeros((b, 210, 160), dtype=torch.bool, device=dev)
  bombs = torch.zeros((b, 210, 160), dtype=torch.bool, device=dev)
  for i in range(NUM_DRONES):
    y, x = state.drone_y[:, i], state.drone_x[:, i]
    drones = drones | (rect(y, y + DRONE_H, x, x + DRONE_W)
                       & state.drone_live[:, i, None, None])
  for i in range(NUM_DRONES):
    y, x = state.bomb_y[:, i], state.bomb_x[:, i]
    bombs = bombs | (rect(y, y + BOMB_H, x, x + BOMB_W)
                     & state.bomb_live[:, i, None, None])
  shot = rect(state.shot_y, state.shot_y + 6, state.shot_x,
              state.shot_x + SHOT_W) & state.shot_live[:, None, None]
  player = rect(PLAYER_Y, PLAYER_Y + PLAYER_H, state.player_x,
                state.player_x + PLAYER_W)
  # Heat bar along the bottom: 10 + heat * (140 / HEAT_MAX), one
  # multiply-add as XLA compiles it (for heats 0-99 it moves the f32 end of
  # 7 of them, and the int32 truncation of none).
  heat_end = f32.fma(state.heat.to(torch.float32), 140.0 / HEAT_MAX, 10.0)
  heat_bar = rect(200, 204, 10, heat_end)
  return render.compose(
      b, dev, (0, 0, 0),
      (_ground(dev), (120, 120, 120)),
      (mother, (170, 80, 170)),
      (drones, (210, 170, 80)),
      (bombs, (236, 140, 30)),
      (shot, (236, 236, 236)),
      (player, (90, 186, 90)),
      (heat_bar, (220, 60, 60)),
  )


def assault_lives(state: AssaultState) -> torch.Tensor:
  return state.lives


GAME = register_game(Game(
    name="assault",
    num_actions=7,
    init=assault_init,
    step=assault_step,
    render=assault_render,
    lives=assault_lives,
    init_draws=assault_init_draws,
    step_draws=assault_step_draws,
    per_frame_draws=True,
))
