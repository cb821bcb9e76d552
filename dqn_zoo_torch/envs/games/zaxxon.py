"""Zaxxon, batched (port of dqn_zoo_tpu/envs/games/zaxxon.py).

Same constants, update order, float expressions and colours as the
reference: a fighter flies through a scrolling fortress, four enemy slots
(drones in the air, turrets on the ground) and a wall with a gap scroll
toward it, a shot pays 50 a drone and 100 a turret, a wall or an enemy
costs one of 3 lives, 15,000-frame episodes, the 18 joystick actions. The
reference splits a key carried in the state at init (one key for the gap,
one for each enemy, which `_spawn_enemy` splits again into its x offset, y
and turret coin) and on every raw frame (four enemy keys for the
recycling, split again the same way, and one for a new gap). Here the state
carries no key, `init` takes `ZaxxonInitDraws` and `step` takes
`ZaxxonStepDraws`, the draws of one raw frame, a y among them for every
enemy, turrets too, as the reference draws it. The game declares
`per_frame_draws`, so the vector env hands each frame of a group and of
the noop burn its own.

XLA keeps the spawn's `x_base + uniform(0, 140)` as a product, a max and
a sum apart, so the port adds the drawn offset; the step takes no product.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from dqn_zoo_torch.envs import render
from dqn_zoo_torch.envs.api import Game, register_game
from dqn_zoo_torch.envs.games import first_true, isin

SHIP_X = 28.0
SHIP_W, SHIP_H = 14, 8
Y_MIN, Y_MAX = 44.0, 180.0
SHIP_SPEED = 2.5
SCROLL = 2.0  # world scroll speed (enemies and walls move left)
SHOT_SPEED = 6.0
NUM_ENEMIES = 4
ENEMY_W, ENEMY_H = 10, 8
TURRET_Y = 172.0  # ground turret altitude
DRONE_POINTS = 50.0
TURRET_POINTS = 100.0
WALL_EVERY = 360.0  # world-x distance between walls
WALL_W = 6
GAP_H = 36.0
SPAWN_X = 220.0
SPAWN_SPREAD = 140.0  # a spawn's x offset is drawn in [0, SPAWN_SPREAD)
TURRET_PROB = 0.4
LIVES = 3
EPISODE_FRAMES = 15000
DEATH_FREEZE = 40

# The joystick's rows of the 18 actions (ALE order).
_UP = (2, 6, 7, 10, 14, 15)
_DOWN = (5, 8, 9, 13, 16, 17)
_FIRE = (1, 10, 11, 12, 13, 14, 15, 16, 17)


class ZaxxonState(NamedTuple):
  ship_y: torch.Tensor  # (B,) f32
  shot_x: torch.Tensor  # (B,) f32 (< 0: inactive)
  shot_y: torch.Tensor  # (B,) f32
  enemy_x: torch.Tensor  # (B, K) f32
  enemy_y: torch.Tensor  # (B, K) f32
  enemy_turret: torch.Tensor  # (B, K) bool
  enemy_alive: torch.Tensor  # (B, K) bool
  wall_x: torch.Tensor  # (B,) f32, the next wall's screen x
  gap_y: torch.Tensor  # (B,) f32, the wall gap's centre
  lives: torch.Tensor  # (B,) i32
  freeze: torch.Tensor  # (B,) i32
  frame: torch.Tensor  # (B,) i32


class ZaxxonInitDraws(NamedTuple):
  enemy_dx: torch.Tensor  # (B, K) f32 in [0, 140), added to x_base
  enemy_y: torch.Tensor  # (B, K) f32 in [Y_MIN, Y_MAX - 30)
  enemy_turret: torch.Tensor  # (B, K) bool, true with TURRET_PROB
  gap_y: torch.Tensor  # (B,) f32 in [Y_MIN + 18, Y_MAX - 18)


class ZaxxonStepDraws(NamedTuple):
  spawn_dx: torch.Tensor  # (B, K) f32 in [0, 140), added to SPAWN_X
  spawn_y: torch.Tensor  # (B, K) f32 in [Y_MIN, Y_MAX - 30)
  spawn_turret: torch.Tensor  # (B, K) bool, true with TURRET_PROB
  gap_y: torch.Tensor  # (B,) f32 in [Y_MIN + 18, Y_MAX - 18), a new gap


def _draw(gen, lead, device):
  """(dx, y, turret, gap) with leading shape `lead` (the gap's without K)."""
  shape = lead + (NUM_ENEMIES,)
  u = torch.rand((3,) + shape, generator=gen, device=device)
  g = torch.rand(lead, generator=gen, device=device)
  return (u[0] * SPAWN_SPREAD, u[1] * (Y_MAX - 30 - Y_MIN) + Y_MIN,
          u[2] < TURRET_PROB, g * (Y_MAX - Y_MIN - GAP_H) + (Y_MIN
                                                             + GAP_H / 2))


def zaxxon_init_draws(gen, b, device) -> ZaxxonInitDraws:
  return ZaxxonInitDraws(*_draw(gen, (b,), device))


def zaxxon_step_draws(gen, b, device, frames: int) -> ZaxxonStepDraws:
  """The spawns and gaps of `frames` raw frames: (frames, B, K) and
  (frames, B)."""
  return ZaxxonStepDraws(*_draw(gen, (frames, b), device))


def _spawn_y(turret, y):
  return torch.where(turret, TURRET_Y, y.to(torch.float32))


@functools.lru_cache(maxsize=None)
def _x_base(device: torch.device) -> torch.Tensor:
  """(1, K) f32: the enemies' first x before their drawn offsets."""
  return torch.tensor([120.0 + 90.0 * i for i in range(NUM_ENEMIES)],
                      dtype=torch.float32, device=device)[None]


def zaxxon_init(draws: ZaxxonInitDraws) -> ZaxxonState:
  b = draws.gap_y.shape[0]
  dev = draws.gap_y.device
  f = lambda v: torch.full((b,), v, dtype=torch.float32, device=dev)
  i = lambda v: torch.full((b,), v, dtype=torch.int32, device=dev)
  return ZaxxonState(
      ship_y=f(110.0), shot_x=f(-1.0), shot_y=f(0.0),
      enemy_x=_x_base(dev) + draws.enemy_dx.to(torch.float32),
      enemy_y=_spawn_y(draws.enemy_turret, draws.enemy_y),
      enemy_turret=draws.enemy_turret.clone(),
      enemy_alive=torch.ones((b, NUM_ENEMIES), dtype=torch.bool,
                             device=dev),
      wall_x=f(300.0), gap_y=draws.gap_y.to(torch.float32), lives=i(LIVES),
      freeze=i(0), frame=i(0))


def zaxxon_step(state: ZaxxonState, action: torch.Tensor,
                draws: ZaxxonStepDraws):
  frame = state.frame + 1
  frozen = state.freeze > 0
  freeze = torch.clamp(state.freeze - 1, min=0)
  zero = torch.zeros_like(state.ship_y)

  up = isin(action, _UP)
  down = isin(action, _DOWN)
  fire = isin(action, _FIRE)
  dy = torch.where(up, -SHIP_SPEED, torch.where(down, SHIP_SPEED, zero))
  ship_y = torch.clamp(state.ship_y + torch.where(frozen, zero, dy),
                       Y_MIN, Y_MAX)

  # One shot slot, fired when empty, with a limited range.
  shot_live = state.shot_x >= 0
  do_fire = fire & ~shot_live & ~frozen
  shot_x = torch.where(do_fire, SHIP_X + SHIP_W,
                       torch.where(shot_live, state.shot_x + SHOT_SPEED,
                                   -1.0))
  shot_y = torch.where(do_fire, ship_y + SHIP_H / 2, state.shot_y)
  shot_x = torch.where(shot_x > 140.0, -1.0, shot_x)

  # The enemies and the wall scroll.
  scroll = torch.where(frozen, 0.0, SCROLL)
  ex = state.enemy_x - scroll[:, None]
  wall_x = state.wall_x - scroll

  # A shot hits the first live enemy its box overlaps.
  hx, hy = shot_x[:, None], shot_y[:, None]
  hit = ((state.shot_x >= 0)[:, None]
         & (hx + 2 >= ex) & (hx <= ex + ENEMY_W)
         & (hy + 2 >= state.enemy_y) & (hy <= state.enemy_y + ENEMY_H)
         & state.enemy_alive)
  any_hit = hit.any(dim=1)
  killed = first_true(hit)  # one target a shot
  turret_hit = (killed & state.enemy_turret).any(dim=1)
  reward = torch.where(any_hit, torch.where(turret_hit, TURRET_POINTS,
                                            DRONE_POINTS), zero)
  alive = state.enemy_alive & ~killed
  shot_x = torch.where(any_hit, -1.0, shot_x)

  # Dead and passed enemies come back ahead of the ship from the draws.
  recycle = ~alive | (ex < -ENEMY_W)
  ex = torch.where(recycle, SPAWN_X + draws.spawn_dx.to(torch.float32), ex)
  ey = torch.where(recycle, _spawn_y(draws.spawn_turret, draws.spawn_y),
                   state.enemy_y)
  et = torch.where(recycle, draws.spawn_turret, state.enemy_turret)
  alive = alive | recycle

  # A passed wall comes back with a new gap.
  wall_gone = wall_x < -WALL_W
  gap_y = torch.where(wall_gone, draws.gap_y.to(torch.float32), state.gap_y)
  wall_x = torch.where(wall_gone, wall_x + WALL_EVERY, wall_x)

  # Crashes: the wall outside its gap, or an enemy's body.
  ship_box_x1 = SHIP_X + SHIP_W
  wall_overlap = (wall_x <= ship_box_x1) & (wall_x + WALL_W >= SHIP_X)
  in_gap = ((ship_y >= gap_y - GAP_H / 2)
            & (ship_y + SHIP_H <= gap_y + GAP_H / 2))
  wall_crash = wall_overlap & ~in_gap & ~frozen
  sy = ship_y[:, None]
  enemy_crash = ((ex <= ship_box_x1) & (ex + ENEMY_W >= SHIP_X)
                 & (ey <= sy + SHIP_H) & (ey + ENEMY_H >= sy)
                 & alive).any(dim=1) & ~frozen
  died = wall_crash | enemy_crash
  lives = state.lives - died.to(torch.int32)
  done = (lives <= 0) | (frame >= EPISODE_FRAMES)
  # A death recentres the ship, clears the oncoming wall and pushes the
  # nearby enemies on.
  ship_y = torch.where(died, 110.0, ship_y)
  wall_x = torch.where(died, wall_x + WALL_EVERY, wall_x)
  ex = torch.where(died[:, None] & (ex < 120.0), ex + 200.0, ex)
  freeze = torch.where(died, DEATH_FREEZE, freeze).to(torch.int32)
  shot_x = torch.where(died, -1.0, shot_x)

  new_state = ZaxxonState(ship_y, shot_x, shot_y, ex, ey, et, alive,
                          wall_x, gap_y, lives, freeze, frame)
  return new_state, reward, done, died & ~done


@functools.lru_cache(maxsize=None)
def _scenery(device: torch.device) -> tuple:
  """The ground's (mask, rgb) layer on `device`, made there once."""
  return ((render.rect_mask(182, 210, 0, 160, device), (60, 70, 60)),)


def zaxxon_render(state: ZaxxonState) -> torch.Tensor:
  b = state.ship_y.shape[0]
  dev = state.ship_y.device
  rect = lambda *box: render.rect_mask(*box, dev)
  wx = state.wall_x
  wall_top = rect(int(Y_MIN) - 8, state.gap_y - GAP_H / 2, wx, wx + WALL_W)
  wall_bot = rect(state.gap_y + GAP_H / 2, 182, wx, wx + WALL_W)
  ship = rect(state.ship_y, state.ship_y + SHIP_H, int(SHIP_X),
              int(SHIP_X + SHIP_W))
  shot = rect(state.shot_y, state.shot_y + 2, state.shot_x,
              state.shot_x + 4) & (state.shot_x >= 0)[:, None, None]
  # Every enemy's box at once, (B, K, 210, 160), then the unions of the
  # drones and of the turrets.
  ey, ex = state.enemy_y, state.enemy_x
  m = rect(ey, ey + ENEMY_H, ex, ex + ENEMY_W) \
      & state.enemy_alive[:, :, None, None]
  turret = state.enemy_turret[:, :, None, None]
  lives_bar = rect(200, 206, 8, 8 + 10 * state.lives)
  return render.compose(
      b, dev, (18, 24, 48), *_scenery(dev),
      (wall_top, (140, 140, 160)),
      (wall_bot, (140, 140, 160)),
      ((m & turret).any(dim=1), (188, 96, 60)),
      ((m & ~turret).any(dim=1), (90, 180, 90)),
      (shot, (240, 240, 120)),
      (ship, (220, 220, 230)),
      (lives_bar, (220, 220, 230)),
  )


def zaxxon_lives(state: ZaxxonState) -> torch.Tensor:
  return state.lives


GAME = register_game(Game(
    name="zaxxon",
    num_actions=18,
    init=zaxxon_init,
    step=zaxxon_step,
    render=zaxxon_render,
    lives=zaxxon_lives,
    init_draws=zaxxon_init_draws,
    step_draws=zaxxon_step_draws,
    per_frame_draws=True,
))
