"""Freeway, batched (port of dqn_zoo_tpu/envs/games/freeway.py).

Same constants, update order, float expressions and colours as the
reference: a chicken crosses ten lanes of traffic against an 8,160-frame
clock, +1 a crossing, knocked back by a car, no lives. The reference draws
only at init (the cars' start columns), from a key carried in the state;
here the state carries no key, `init` takes `FreewayInitDraws`, and a step
draws nothing.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from dqn_zoo_torch.envs import render
from dqn_zoo_torch.envs.api import Game, register_game

NUM_LANES = 10
LANE_TOP = 24  # first lane's top edge
LANE_H = 16
ROAD_BOTTOM = LANE_TOP + NUM_LANES * LANE_H  # 184
GOAL_Y = 20.0
START_Y = 186.0
CHICKEN_X = 44.0
CHICKEN_W, CHICKEN_H = 6, 8
CHICKEN_SPEED = 2.0
KNOCKBACK = 24.0
CAR_W, CAR_H = 16, 10
EPISODE_FRAMES = 8160  # 2 min 16 s at 60 Hz, the ALE game clock
# Per-lane speeds (px/frame); the bottom five lanes drive right, the top
# five left.
LANE_SPEEDS = (1.2, 2.0, 1.5, 2.5, 1.8, 1.8, 2.5, 1.5, 2.0, 1.2)
LANE_DIRS = (1.0,) * 5 + (-1.0,) * 5
CAR_COLORS = ((167, 26, 26), (184, 50, 50), (200, 72, 72), (198, 108, 58),
              (180, 122, 48), (162, 134, 56), (134, 134, 29), (84, 138, 210),
              (66, 114, 194), (45, 87, 176))
LANE_TOPS = tuple(LANE_TOP + i * LANE_H + (LANE_H - CAR_H) // 2
                  for i in range(NUM_LANES))


class FreewayState(NamedTuple):
  chicken_y: torch.Tensor  # (B,) f32
  car_x: torch.Tensor  # (B, NUM_LANES) f32, left edge (wraps mod 160)
  frame: torch.Tensor  # (B,) i32 — raw frames this episode


class FreewayInitDraws(NamedTuple):
  car_x: torch.Tensor  # (B, NUM_LANES) f32 in [0, 160)


def freeway_init_draws(gen, b, device) -> FreewayInitDraws:
  u = torch.rand((b, NUM_LANES), generator=gen, device=device)
  return FreewayInitDraws(car_x=u * 160.0)


def freeway_step_draws(gen, b, device) -> None:
  del gen, b, device  # a step consumes no random number


def freeway_init(draws: FreewayInitDraws) -> FreewayState:
  b = draws.car_x.shape[0]
  dev = draws.car_x.device
  return FreewayState(
      chicken_y=torch.full((b,), START_Y, dtype=torch.float32, device=dev),
      car_x=draws.car_x.to(torch.float32),
      frame=torch.zeros((b,), dtype=torch.int32, device=dev),
  )


class _Tables(NamedTuple):
  velocity: torch.Tensor  # (1, NUM_LANES) f32, LANE_DIRS * LANE_SPEEDS
  lane_y: torch.Tensor  # (1, NUM_LANES) f32, car tops
  scenery: tuple  # (mask, rgb) layers that never move


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> _Tables:
  """The step's and the render's constant tensors on `device`, copied there
  once."""
  t = lambda v: torch.tensor(v, dtype=torch.float32, device=device)[None, :]
  mask = lambda *box: render.rect_mask(*box, device)
  grass = mask(0, LANE_TOP, 0, 160) | mask(ROAD_BOTTOM, 210, 0, 160)
  stripes = torch.zeros((210, 160), dtype=torch.bool, device=device)
  for i in range(1, NUM_LANES):
    stripes = stripes | mask(LANE_TOP + i * LANE_H,
                             LANE_TOP + i * LANE_H + 1, 0, 160)
  median = mask(LANE_TOP + 5 * LANE_H - 1, LANE_TOP + 5 * LANE_H + 1, 0, 160)
  return _Tables(
      velocity=t(LANE_DIRS) * t(LANE_SPEEDS), lane_y=t(LANE_TOPS),
      scenery=((grass, (110, 156, 66)), (stripes, (214, 214, 214)),
               (median, (255, 255, 255))))


def freeway_step(state: FreewayState, action: torch.Tensor, draws=None):
  del draws
  c = _tables(state.chicken_y.device)
  up = action == 1
  down = action == 2
  zero = torch.zeros_like(state.chicken_y)
  dy = torch.where(up, -CHICKEN_SPEED,
                   torch.where(down, CHICKEN_SPEED, zero))
  cy = torch.clamp(state.chicken_y + dy, GOAL_Y - 2.0, START_Y)

  # Traffic: one car a lane at its lane's speed, wrapping around. The
  # remainder is jnp.mod's: fmod, moved into [0, 160) where negative.
  moved = state.car_x + c.velocity
  rem = torch.fmod(moved, 160.0)
  car_x = torch.where(rem < 0, rem + 160.0, rem)

  # Collision: the chicken's box against the car of each lane.
  lane_y = c.lane_y
  yy = cy[:, None]
  overlap_y = (yy + CHICKEN_H >= lane_y) & (yy <= lane_y + CAR_H)
  overlap_x = (car_x <= CHICKEN_X + CHICKEN_W) & (car_x + CAR_W >= CHICKEN_X)
  hit = (overlap_y & overlap_x).any(dim=1)
  cy = torch.where(hit, torch.clamp(cy + KNOCKBACK, max=START_Y), cy)

  # A crossing scores and sends the chicken back to the start.
  crossed = cy <= GOAL_Y
  reward = torch.where(crossed, 1.0, zero)
  cy = torch.where(crossed, START_Y, cy)

  frame = state.frame + 1
  done = frame >= EPISODE_FRAMES
  return (FreewayState(cy, car_x, frame), reward, done,
          torch.zeros_like(done))


def freeway_render(state: FreewayState) -> torch.Tensor:
  b = state.chicken_y.shape[0]
  dev = state.chicken_y.device
  c = _tables(dev)
  cars = []
  for i, top in enumerate(LANE_TOPS):
    x = state.car_x[:, i]
    cars.append((render.rect_mask(top, top + CAR_H, x, x + CAR_W, dev),
                 CAR_COLORS[i]))
  chicken = render.rect_mask(
      state.chicken_y, state.chicken_y + CHICKEN_H,
      int(CHICKEN_X), int(CHICKEN_X) + CHICKEN_W, dev)
  return render.compose(b, dev, (142, 142, 142), *c.scenery, *cars,
                        (chicken, (252, 252, 84)))


def freeway_lives(state: FreewayState) -> torch.Tensor:
  return torch.ones_like(state.frame)


GAME = register_game(Game(
    name="freeway",
    num_actions=3,
    init=freeway_init,
    step=freeway_step,
    render=freeway_render,
    lives=freeway_lives,
    init_draws=freeway_init_draws,
    step_draws=freeway_step_draws,
))
