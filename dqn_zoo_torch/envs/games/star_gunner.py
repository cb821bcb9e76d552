"""Star Gunner, batched (port of dqn_zoo_tpu/envs/games/star_gunner.py).

Same constants, update order, float expressions and colours as the
reference: a gunship flies in both axes on the left half of a star field,
three raiders warp in at the right edge, sweep left while jinking toward
its altitude and fire homing bolts; a raider shot down pays 100, a bolt or
a raider reaching the ship costs one of 5 lives, the 18 joystick actions.
The reference splits a key carried in the state at init (the ship's row,
the raiders' rows) and on every raw frame (each raider's jink, respawn row
and bolt test); here the state carries no key, `init` takes
`StarGunnerInitDraws` and `step` takes `StarGunnerStepDraws`, the draws of
one raw frame. The game declares `per_frame_draws`, so the vector env hands
each frame of a group and of the noop burn its own.

The raiders take the reference's compiled arithmetic (`envs.f32`): XLA
fuses the speed's `0.3 * (wave // 10)` into its sum with 1.3, and of the
jink's two products, `0.8 * rvy + 0.4 * jink`, it fuses the first into the
sum and rounds the second on its own.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from dqn_zoo_torch.envs import f32, render
from dqn_zoo_torch.envs.api import Game, constant, register_game
from dqn_zoo_torch.envs.games import first_true, joystick

TOP, BOTTOM = 40.0, 196.0
LEFT, RIGHT = 8.0, 152.0
SHIP_W, SHIP_H = 12, 8
SHIP_SPEED = 2.6
NUM_RAIDERS = 3
RAIDER_W, RAIDER_H = 10, 7
RAIDER_SPEED = 1.3
SPAWN_DELAY = 70
SHOT_W, SHOT_SPEED = 6, 7.0  # horizontal laser
BOLT, BOLT_SPEED = 3, 2.4
BOLT_PROB = 0.02
LIVES = 5
HIT_PAUSE = 35
RAIDER_POINTS = 100.0


class StarGunnerState(NamedTuple):
  sx: torch.Tensor  # (B,) f32 ship left edge
  sy: torch.Tensor  # (B,) f32
  rx: torch.Tensor  # (B, N) f32 raiders
  ry: torch.Tensor  # (B, N) f32
  rvy: torch.Tensor  # (B, N) f32 vertical jink velocity
  rlive: torch.Tensor  # (B, N) bool
  rdelay: torch.Tensor  # (B, N) i32 respawn countdown
  shot_x: torch.Tensor  # (B,) f32 (travels right)
  shot_y: torch.Tensor  # (B,) f32
  shot_live: torch.Tensor  # (B,) bool
  bx: torch.Tensor  # (B, N) f32 bolts
  by: torch.Tensor  # (B, N) f32
  blive: torch.Tensor  # (B, N) bool
  lives: torch.Tensor  # (B,) i32
  wave: torch.Tensor  # (B,) i32 kills
  hit_pause: torch.Tensor  # (B,) i32


class StarGunnerInitDraws(NamedTuple):
  sy: torch.Tensor  # (B,) f32 in [TOP + 20, BOTTOM - 30)
  ry: torch.Tensor  # (B, N) f32 in [TOP, BOTTOM - RAIDER_H)


class StarGunnerStepDraws(NamedTuple):
  jink: torch.Tensor  # (B, N) f32 in [-0.8, 0.8)
  spawn_y: torch.Tensor  # (B, N) f32 in [TOP, BOTTOM - RAIDER_H)
  bolt_u: torch.Tensor  # (B, N) U[0, 1): a raider fires below BOLT_PROB


def _rows(gen, shape, device):
  u = torch.rand(shape, generator=gen, device=device)
  return u * (BOTTOM - RAIDER_H - TOP) + TOP


def star_gunner_init_draws(gen, b, device) -> StarGunnerInitDraws:
  u = torch.rand((b,), generator=gen, device=device)
  return StarGunnerInitDraws(
      sy=u * (BOTTOM - 30 - TOP - 20) + (TOP + 20),
      ry=_rows(gen, (b, NUM_RAIDERS), device))


def star_gunner_step_draws(gen, b, device,
                           frames: int) -> StarGunnerStepDraws:
  """The jinks, respawn rows and bolt tests of `frames` raw frames:
  (frames, B, N) each."""
  shape = (frames, b, NUM_RAIDERS)
  u = torch.rand(shape, generator=gen, device=device)
  return StarGunnerStepDraws(
      jink=u * 1.6 - 0.8, spawn_y=_rows(gen, shape, device),
      bolt_u=torch.rand(shape, generator=gen, device=device))


def star_gunner_init(draws: StarGunnerInitDraws) -> StarGunnerState:
  b = draws.sy.shape[0]
  dev = draws.sy.device
  n = NUM_RAIDERS
  fz = lambda *s: torch.zeros((b,) + s, dtype=torch.float32, device=dev)
  bz = lambda *s: torch.zeros((b,) + s, dtype=torch.bool, device=dev)
  iz = lambda *s: torch.zeros((b,) + s, dtype=torch.int32, device=dev)
  return StarGunnerState(
      sx=torch.full((b,), 24.0, dtype=torch.float32, device=dev),
      sy=draws.sy.to(torch.float32),
      rx=torch.full((b, n), RIGHT, dtype=torch.float32, device=dev),
      ry=draws.ry.to(torch.float32), rvy=fz(n), rlive=bz(n),
      rdelay=constant((5, 35, 65), torch.int32, dev).expand(b, n).clone(),
      shot_x=fz(), shot_y=fz(), shot_live=bz(), bx=fz(n), by=fz(n),
      blive=bz(n),
      lives=torch.full((b,), LIVES, dtype=torch.int32, device=dev),
      wave=iz(), hit_pause=iz())


def star_gunner_step(state: StarGunnerState, action: torch.Tensor,
                     draws: StarGunnerStepDraws):
  dx, dy, fire = joystick(action)
  sx = torch.clamp(state.sx + dx * SHIP_SPEED, LEFT, 76.0)  # left half
  sy = torch.clamp(state.sy + dy * SHIP_SPEED, TOP, BOTTOM - SHIP_H)

  # `wave` counts kills; the raiders speed up every 10 of them.
  speed = f32.fma(torch.div(state.wave, 10, rounding_mode="floor").to(
      torch.float32), 0.3, RAIDER_SPEED)
  # The raiders sweep left, jinking toward the ship's altitude.
  jink = torch.clamp(sy[:, None] - state.ry, -1.0, 1.0) \
      + draws.jink.to(torch.float32)
  rvy = f32.fma(state.rvy, 0.8, 0.4 * jink)
  zero = torch.zeros_like(state.rx)
  rx = state.rx - torch.where(state.rlive, speed[:, None], zero)
  ry = torch.clamp(state.ry + torch.where(state.rlive, rvy, zero),
                   TOP, BOTTOM - RAIDER_H)
  rdelay = torch.clamp(state.rdelay - 1, min=0)
  respawn = ~state.rlive & (rdelay == 0)
  rx = torch.where(respawn, RIGHT, rx)
  ry = torch.where(respawn, draws.spawn_y.to(torch.float32), ry)
  rlive = state.rlive | respawn

  # The laser travels right from the ship's nose.
  do_fire = fire & ~state.shot_live
  shot_x = torch.where(do_fire, sx + SHIP_W, state.shot_x)
  shot_y = torch.where(do_fire, sy + SHIP_H / 2, state.shot_y)
  shot_live = state.shot_live | do_fire
  shot_x = shot_x + torch.where(shot_live, SHOT_SPEED, 0.0)
  shot_live = shot_live & (shot_x < RIGHT + 8.0)

  hx, hy = shot_x[:, None], shot_y[:, None]
  hit = (shot_live[:, None] & rlive
         & (hx + SHOT_W >= rx) & (hx <= rx + RAIDER_W)
         & (hy >= ry) & (hy <= ry + RAIDER_H))
  any_hit = hit.any(dim=1)
  kill = first_true(hit)  # one kill a laser
  rlive = rlive & ~kill
  rdelay = torch.where(kill, SPAWN_DELAY, rdelay)
  shot_live = shot_live & ~any_hit
  reward = torch.where(any_hit, RAIDER_POINTS, 0.0)
  wave = state.wave + kill.sum(dim=1, dtype=torch.int32)

  # Bolts home on the ship's altitude.
  do_bolt = rlive & ~state.blive & (draws.bolt_u < BOLT_PROB)
  bx = torch.where(do_bolt, rx, state.bx)
  by = torch.where(do_bolt, ry + RAIDER_H / 2, state.by)
  blive = state.blive | do_bolt
  steer = torch.clamp((sy + SHIP_H / 2)[:, None] - by, -1.2, 1.2)
  bx = bx - torch.where(blive, BOLT_SPEED, 0.0)
  by = by + torch.where(blive, steer, zero)
  blive = blive & (bx > LEFT - 6.0)

  vulnerable = state.hit_pause <= 0
  hit_pause = torch.clamp(state.hit_pause - 1, min=0)
  ssx, ssy = sx[:, None], sy[:, None]
  bolt_hit = (blive & (bx <= ssx + SHIP_W) & (bx + BOLT >= ssx)
              & (by + BOLT >= ssy) & (by <= ssy + SHIP_H))
  ram = (rlive & (rx <= ssx + SHIP_W) & (rx + RAIDER_W >= ssx)
         & (ry + RAIDER_H >= ssy) & (ry <= ssy + SHIP_H))
  off_left = rlive & (rx < LEFT)  # a raider escapes past the ship's line
  rlive = rlive & ~off_left & ~ram
  rdelay = torch.where(off_left | ram, SPAWN_DELAY, rdelay).to(torch.int32)
  destroyed = (bolt_hit.any(dim=1) | ram.any(dim=1)) & vulnerable
  blive = blive & ~destroyed[:, None]
  lives = state.lives - destroyed.to(torch.int32)
  hit_pause = torch.where(destroyed, HIT_PAUSE, hit_pause).to(torch.int32)

  done = lives <= 0
  new_state = StarGunnerState(
      sx, sy, rx, ry, rvy, rlive, rdelay, shot_x, shot_y, shot_live,
      bx, by, blive, lives, wave, hit_pause)
  return new_state, reward, done, destroyed & ~done


@functools.lru_cache(maxsize=None)
def _stars(device: torch.device) -> torch.Tensor:
  return render.rect_mask(int(TOP - 4), int(TOP - 2), 0, 160, device)


def star_gunner_render(state: StarGunnerState) -> torch.Tensor:
  b = state.sx.shape[0]
  dev = state.sx.device
  rect = lambda *box: render.rect_mask(*box, dev)
  # Every raider's and bolt's box at once, (B, N, 210, 160), then their
  # unions.
  raiders = (rect(state.ry, state.ry + RAIDER_H, state.rx,
                  state.rx + RAIDER_W)
             & state.rlive[:, :, None, None]).any(dim=1)
  bolts = (rect(state.by, state.by + BOLT, state.bx, state.bx + BOLT)
           & state.blive[:, :, None, None]).any(dim=1)
  shot = rect(state.shot_y - 1, state.shot_y + 1, state.shot_x,
              state.shot_x + SHOT_W) & state.shot_live[:, None, None]
  ship = rect(state.sy, state.sy + SHIP_H, state.sx, state.sx + SHIP_W)
  return render.compose(
      b, dev, (4, 4, 20),
      (_stars(dev), (70, 70, 110)),
      (raiders, (226, 110, 110)),
      (bolts, (250, 200, 80)),
      (shot, (250, 250, 250)),
      (ship, (110, 200, 110)),
  )


def star_gunner_lives(state: StarGunnerState) -> torch.Tensor:
  return state.lives


GAME = register_game(Game(
    name="star_gunner",
    num_actions=18,
    init=star_gunner_init,
    step=star_gunner_step,
    render=star_gunner_render,
    lives=star_gunner_lives,
    init_draws=star_gunner_init_draws,
    step_draws=star_gunner_step_draws,
    per_frame_draws=True,
))
