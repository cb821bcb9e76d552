"""Enduro, batched (port of dqn_zoo_tpu/envs/games/enduro.py).

Same constants, update order, float expressions and colours as the
reference: the player's car overtakes traffic on a three-lane road, +1 a
car overtaken and -1 a car that passes back, a collision drops the speed
to a crawl, no lives, episodes of 10,000 frames, 9 actions. The reference
splits a key carried in the state at init (each car's distance and lane)
and on every raw frame (a respawn distance and lane for each car); here the
state carries no key, `init` takes `EnduroInitDraws` and `step` takes
`EnduroStepDraws`, the draws of one raw frame. The game declares
`per_frame_draws`, so the vector env hands each frame of a group and of the
noop burn its own.

The render takes the reference's compiled arithmetic (`envs.f32`): XLA
multiplies by 0.0025f where the source divides by 400, takes the square
root correctly rounded (here in float64, which rounds to the same f32),
and fuses each product that feeds one sum into a multiply-add: the car's
row, scale, column and top edge. The half-width `CAR_W * scale / 2`, folded
into `scale * 7`, feeds two sums (the box's left and right edges) and is
rounded on its own.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from dqn_zoo_torch.envs import f32, render
from dqn_zoo_torch.envs.api import Game, register_game
from dqn_zoo_torch.envs.games import isin

ROAD_TOP = 54.0  # the horizon
ROAD_BOTTOM = 182.0
NUM_LANES = 3
LANE_X = (52.0, 76.0, 100.0)  # lane centre x at the bottom of the screen
CAR_W, CAR_H = 14, 10
PLAYER_Y = 160.0
PLAYER_SPEED_X = 2.5
MAX_SPEED = 6.0
MIN_SPEED = 0.0
ACCEL = 0.08
BRAKE = 0.2
DRAG = 0.02
TRAFFIC_SPEED = 2.4  # the traffic's own speed (world units a frame)
CRASH_SPEED = 0.8  # the speed after a collision
NUM_CARS = 6
SPAWN_AHEAD = 400.0  # the band of world z the traffic lives in
EPISODE_FRAMES = 10000
CAR_COLORS = ((192, 88, 88), (88, 120, 192), (104, 172, 104),
              (184, 150, 70), (150, 110, 180), (180, 180, 92))

FIRE_ACTIONS = (1, 7, 8)
RIGHT_ACTIONS = (2, 5, 7)
LEFT_ACTIONS = (3, 6, 8)
BRAKE_ACTIONS = (4, 5, 6)


class EnduroState(NamedTuple):
  player_x: torch.Tensor  # (B,) f32 screen x of the player's centre
  speed: torch.Tensor  # (B,) f32 world units a frame
  car_z: torch.Tensor  # (B, NUM_CARS) f32 world distance ahead (+)
  car_lane: torch.Tensor  # (B, NUM_CARS) i32
  passed: torch.Tensor  # (B,) i32 net cars overtaken
  frame: torch.Tensor  # (B,) i32


class EnduroInitDraws(NamedTuple):
  car_z: torch.Tensor  # (B, NUM_CARS) f32 in [200, 400)
  car_lane: torch.Tensor  # (B, NUM_CARS) i32 in [0, NUM_LANES)


class EnduroStepDraws(NamedTuple):
  new_z: torch.Tensor  # (B, NUM_CARS) f32 in [240, 400), a respawn's z
  new_lane: torch.Tensor  # (B, NUM_CARS) i32 in [0, NUM_LANES)


def _spawn(gen, shape, device, low):
  z = torch.rand(shape, generator=gen, device=device) * (SPAWN_AHEAD - low) \
      + low
  lane = torch.randint(0, NUM_LANES, shape, generator=gen, device=device)
  return z, lane.to(torch.int32)


def enduro_init_draws(gen, b, device) -> EnduroInitDraws:
  return EnduroInitDraws(*_spawn(gen, (b, NUM_CARS), device,
                                 SPAWN_AHEAD * 0.5))


def enduro_step_draws(gen, b, device, frames: int) -> EnduroStepDraws:
  """The respawns of `frames` raw frames: (frames, B, NUM_CARS) each."""
  return EnduroStepDraws(*_spawn(gen, (frames, b, NUM_CARS), device,
                                 SPAWN_AHEAD * 0.6))


def enduro_init(draws: EnduroInitDraws) -> EnduroState:
  b = draws.car_z.shape[0]
  dev = draws.car_z.device
  f = lambda v: torch.full((b,), v, dtype=torch.float32, device=dev)
  return EnduroState(
      player_x=f(LANE_X[1]),
      speed=f(CRASH_SPEED),
      car_z=draws.car_z.to(torch.float32),
      car_lane=draws.car_lane.to(torch.int32),
      passed=torch.zeros((b,), dtype=torch.int32, device=dev),
      frame=torch.zeros((b,), dtype=torch.int32, device=dev),
  )


class _Tables(NamedTuple):
  lane_x: torch.Tensor  # (NUM_LANES,) f32
  scenery: tuple  # the sky's and the road's (mask, rgb) layers


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> _Tables:
  """The step's and the render's constant tensors on `device`, copied there
  once."""
  mask = lambda *box: render.rect_mask(*box, device)
  # The road's edges converge toward the horizon: three nested bands.
  road = (mask(int(ROAD_TOP), 100, 56, 104) | mask(100, 140, 44, 116)
          | mask(140, int(ROAD_BOTTOM), 32, 128))
  return _Tables(
      lane_x=torch.tensor(LANE_X, dtype=torch.float32, device=device),
      scenery=((mask(0, int(ROAD_TOP), 0, 160), (120, 168, 224)),
               (road, (105, 105, 105))))


def enduro_step(state: EnduroState, action: torch.Tensor,
                draws: EnduroStepDraws):
  c = _tables(state.speed.device)
  fire = isin(action, FIRE_ACTIONS)
  right = isin(action, RIGHT_ACTIONS)
  left = isin(action, LEFT_ACTIONS)
  brake = isin(action, BRAKE_ACTIONS)
  zero = torch.zeros_like(state.speed)

  speed = state.speed + torch.where(fire, ACCEL, zero) \
      - torch.where(brake, BRAKE, zero) - DRAG
  speed = torch.clamp(speed, MIN_SPEED, MAX_SPEED)
  px = torch.clamp(state.player_x
                   + (right.to(torch.float32) - left.to(torch.float32))
                   * PLAYER_SPEED_X, LANE_X[0] - 10.0, LANE_X[-1] + 10.0)

  # The traffic approaches at the relative speed; z is the distance ahead.
  rel = speed - TRAFFIC_SPEED
  car_z = state.car_z - rel[:, None]

  # Overtakes: a car crosses from ahead to behind (+1) or back (-1).
  crossed_down = (state.car_z > 0.0) & (car_z <= 0.0)
  crossed_up = (state.car_z <= 0.0) & (car_z > 0.0)

  # A collision: a car crossing (or at) our z in our lane, its width taken
  # in screen space at the player's row.
  lane_x = c.lane_x[state.car_lane.long()]
  same_lane = torch.abs(lane_x - px[:, None]) < CAR_W
  hit = (crossed_down | crossed_up | (torch.abs(car_z) < 2.0)) & same_lane
  any_hit = hit.any(dim=1)
  # It drops us to a crawl and shoves the other car ahead.
  speed = torch.where(any_hit, CRASH_SPEED, speed)
  car_z = torch.where(hit, 12.0, car_z)

  # Only clean crossings count.
  gained = (crossed_down & ~hit).sum(dim=1).to(torch.int32)
  lost = (crossed_up & ~hit).sum(dim=1).to(torch.int32)
  reward = (gained - lost).to(torch.float32)
  passed = state.passed + gained - lost

  # Cars far behind respawn ahead in a random lane.
  recycle = car_z < -60.0
  car_z = torch.where(recycle, draws.new_z.to(torch.float32), car_z)
  car_lane = torch.where(recycle, draws.new_lane.to(torch.int32),
                         state.car_lane)

  frame = state.frame + 1
  done = frame >= EPISODE_FRAMES
  new_state = EnduroState(px, speed, car_z, car_lane, passed, frame)
  return new_state, reward, done, torch.zeros_like(done)


def enduro_render(state: EnduroState) -> torch.Tensor:
  b = state.speed.shape[0]
  dev = state.speed.device
  c = _tables(dev)
  rect = lambda *box: render.rect_mask(*box, dev)
  # The traffic in perspective: nearer is lower and wider (0 near, 1 far).
  t = torch.clamp(state.car_z, 0.0, SPAWN_AHEAD) * f32.recip(SPAWN_AHEAD)
  root = torch.sqrt(t.to(torch.float64)).to(torch.float32)
  y = f32.fma(root, -(PLAYER_Y - ROAD_TOP - 4.0), PLAYER_Y)
  scale = f32.fma(root, -0.7, 1.0)
  lane_x = c.lane_x[state.car_lane.long()]
  # The lanes pinch toward the centre line (80) with distance.
  x = f32.fma(lane_x - 80.0, f32.fma(root, -0.6, 1.0), 80.0)
  top = f32.fma(scale, -float(CAR_H), y)
  half_w = scale * (CAR_W / 2.0)  # rounded: it feeds two sums
  left, right = x - half_w, x + half_w
  ahead = state.car_z > 0.0  # cars behind us are off the screen
  cars = tuple(
      (rect(top[:, i], y[:, i], left[:, i], right[:, i])
       & ahead[:, i, None, None], CAR_COLORS[i]) for i in range(NUM_CARS))
  player = rect(int(PLAYER_Y), int(PLAYER_Y) + CAR_H,
                state.player_x - CAR_W / 2, state.player_x + CAR_W / 2)
  # The odometer: net cars overtaken.
  bar = rect(192, 198, 16, 16 + torch.clamp(state.passed, 0, 128))
  return render.compose(
      b, dev, (110, 156, 66),  # grass
      *c.scenery, *cars,
      (player, (236, 200, 96)),
      (bar, (236, 236, 236)),
  )


def enduro_lives(state: EnduroState) -> torch.Tensor:
  return torch.ones_like(state.frame)


GAME = register_game(Game(
    name="enduro",
    num_actions=9,
    init=enduro_init,
    step=enduro_step,
    render=enduro_render,
    lives=enduro_lives,
    init_draws=enduro_init_draws,
    step_draws=enduro_step_draws,
    per_frame_draws=True,
))
