"""Bowling, batched (port of dqn_zoo_tpu/envs/games/bowling.py).

Same constants, update order, float expressions and colours as the
reference: ten frames of aim-and-roll at a ten-pin triangle, 6 actions, a
point a pin and a +10 strike / +5 spare bonus at the end of a frame, no
lives. The reference draws nothing: its state carries a key that no step
splits. So a step takes no draws, and `BowlingInitDraws` holds no random
number, only the batch size and the device of the states `init` builds.

The pin test takes the reference's compiled arithmetic (`envs.f32`): XLA
fuses the first square of the squared distance into a multiply-add. The
ball's x is an integer on the roll, so that square is exact and the fused
form gives the plain one's answer to `d2 <= 36` for every ball position;
it is written as XLA's all the same.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from dqn_zoo_torch.envs import f32, render
from dqn_zoo_torch.envs.api import Game, register_game

LANE_TOP, LANE_BOT = 60.0, 160.0
BOWLER_X = 24.0
PIN_X0 = 120.0  # nearest pin column
PIN_DX = 9.0
PIN_DY = 11.0
PIN_CY = 110.0  # lane vertical center
BALL_SPEED = 3.0
HOOK_VY = 0.9
PIN_RADIUS = 6.0
NUM_FRAMES = 10
STRIKE_BONUS = 10.0
SPARE_BONUS = 5.0
SETTLE_FRAMES = 40  # pause between rolls

# Pin triangle: columns of 1, 2, 3, 4 pins pointing at the bowler, in Python
# floats and then f32, as the reference builds it.
_PIN_POS = []
for col in range(4):
  for row in range(col + 1):
    _PIN_POS.append((PIN_X0 + col * PIN_DX,
                     PIN_CY + (row - col / 2.0) * PIN_DY))
_PIN_XY = np.asarray(_PIN_POS, np.float32)  # (10, 2)
NUM_PINS = len(_PIN_POS)


class BowlingState(NamedTuple):
  bowler_y: torch.Tensor  # (B,) f32
  ball_x: torch.Tensor  # (B,) f32 (< 0: not rolling)
  ball_y: torch.Tensor  # (B,) f32
  ball_vy: torch.Tensor  # (B,) f32 hook velocity
  hooked: torch.Tensor  # (B,) bool, the roll's hook input used
  pins: torch.Tensor  # (B, 10) bool, standing
  frame_no: torch.Tensor  # (B,) i32, 0..9
  roll_no: torch.Tensor  # (B,) i32, 0..1
  pins_this_frame: torch.Tensor  # (B,) i32, downed so far this frame
  settle: torch.Tensor  # (B,) i32, pause counter
  frame: torch.Tensor  # (B,) i32 raw frame counter


class BowlingInitDraws(NamedTuple):
  batch: torch.Tensor  # (B,) i32 zeros: no draw, the batch and the device


def bowling_init_draws(gen, b, device) -> BowlingInitDraws:
  del gen  # bowling starts every episode alike
  return BowlingInitDraws(
      batch=torch.zeros((b,), dtype=torch.int32, device=device))


def bowling_step_draws(gen, b, device) -> None:
  del gen, b, device  # a step consumes no random number


def bowling_init(draws: BowlingInitDraws) -> BowlingState:
  b = draws.batch.shape[0]
  dev = draws.batch.device
  f = lambda v: torch.full((b,), v, dtype=torch.float32, device=dev)
  i = lambda: torch.zeros((b,), dtype=torch.int32, device=dev)
  return BowlingState(
      bowler_y=f(PIN_CY),
      ball_x=f(-1.0),
      ball_y=f(PIN_CY),
      ball_vy=f(0.0),
      hooked=torch.zeros((b,), dtype=torch.bool, device=dev),
      pins=torch.ones((b, NUM_PINS), dtype=torch.bool, device=dev),
      frame_no=i(),
      roll_no=i(),
      pins_this_frame=i(),
      settle=i(),
      frame=i(),
  )


class _Tables(NamedTuple):
  pin_x: torch.Tensor  # (1, 10) f32
  pin_y: torch.Tensor  # (1, 10) f32
  lane: torch.Tensor  # (210, 160) bool
  pin_boxes: torch.Tensor  # (10, 210, 160) bool, one pin each


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> _Tables:
  """The step's and the render's constant tensors on `device`, copied there
  once. A pin's box takes the reference's int32 conversion of its Python
  float corners, a truncation."""
  xy = torch.from_numpy(_PIN_XY).to(device)
  boxes = torch.stack([
      render.rect_mask(int(py - 4), int(py + 4), int(px - 2), int(px + 2),
                       device) for px, py in _PIN_POS])
  return _Tables(
      pin_x=xy[None, :, 0], pin_y=xy[None, :, 1],
      lane=render.rect_mask(int(LANE_TOP), int(LANE_BOT), 12, 156, device),
      pin_boxes=boxes)


def bowling_step(state: BowlingState, action: torch.Tensor, draws=None):
  del draws
  c = _tables(state.ball_x.device)
  frame = state.frame + 1
  settling = state.settle > 0
  settle = torch.clamp(state.settle - 1, min=0)
  rolling = state.ball_x >= 0

  up = action == 2
  down = action == 5
  fire = action == 1
  zero = torch.zeros_like(state.ball_x)

  # Aim phase: move the bowler.
  dy = torch.where(up, -2.0, torch.where(down, 2.0, zero))
  bowler_y = torch.clamp(
      state.bowler_y + torch.where(rolling | settling, zero, dy),
      LANE_TOP + 6, LANE_BOT - 6)

  # Release.
  release = fire & ~rolling & ~settling
  ball_x = torch.where(release, BOWLER_X + 10.0, state.ball_x)
  ball_y = torch.where(release, bowler_y, state.ball_y)
  ball_vy = torch.where(release, zero, state.ball_vy)
  hooked = state.hooked & ~release

  # One hook input while rolling.
  hook = (up | down) & rolling & ~hooked
  ball_vy = torch.where(hook, torch.where(up, -HOOK_VY, HOOK_VY), ball_vy)
  hooked = hooked | hook

  # Roll.
  moving = rolling | release
  ball_x = torch.where(moving, ball_x + BALL_SPEED, ball_x)
  ball_y = torch.clamp(torch.where(moving, ball_y + ball_vy, ball_y),
                       LANE_TOP + 2, LANE_BOT - 2)

  # Pin hits: standing pins within the radius of the ball fall. The squared
  # distance as XLA compiles it: the x square fused into the sum.
  dx = c.pin_x - ball_x[:, None]
  dy_pin = c.pin_y - ball_y[:, None]
  d2 = f32.fma(dx, dx, dy_pin * dy_pin)
  hit = state.pins & (d2 <= PIN_RADIUS ** 2) & moving[:, None]
  pins = state.pins & ~hit
  downed = hit.sum(dim=1, dtype=torch.int32)
  reward = downed.to(torch.float32)

  # The roll ends past the pins.
  roll_over = moving & (ball_x > PIN_X0 + 3 * PIN_DX + 10)
  pins_this_frame = state.pins_this_frame + downed
  strike = roll_over & (state.roll_no == 0) & (pins_this_frame >= 10)
  frame_done = roll_over & ((state.roll_no == 1) | strike)
  spare = frame_done & ~strike & (pins_this_frame >= 10)
  reward = reward + torch.where(strike, STRIKE_BONUS,
                                torch.where(spare, SPARE_BONUS, zero))

  ball_x = torch.where(roll_over, -1.0, ball_x)
  settle = torch.where(roll_over, SETTLE_FRAMES, settle).to(torch.int32)
  roll_no = torch.where(
      frame_done, 0,
      torch.where(roll_over, state.roll_no + 1, state.roll_no)
  ).to(torch.int32)
  frame_no = state.frame_no + frame_done.to(torch.int32)
  pins = pins | frame_done[:, None]
  pins_this_frame = torch.where(frame_done, 0, pins_this_frame).to(
      torch.int32)

  done = frame_no >= NUM_FRAMES
  new_state = BowlingState(bowler_y, ball_x, ball_y, ball_vy, hooked, pins,
                           frame_no, roll_no, pins_this_frame, settle, frame)
  return new_state, reward, done, torch.zeros_like(done)


def bowling_render(state: BowlingState) -> torch.Tensor:
  b = state.ball_x.shape[0]
  dev = state.ball_x.device
  c = _tables(dev)
  bowler = render.rect_mask(state.bowler_y - 8, state.bowler_y + 8,
                            int(BOWLER_X - 6), int(BOWLER_X + 6), dev)
  ball = render.rect_mask(state.ball_y - 3, state.ball_y + 3,
                          state.ball_x - 3, state.ball_x + 3, dev)
  ball = ball & (state.ball_x >= 0)[:, None, None]
  pins = (c.pin_boxes & state.pins[:, :, None, None]).any(dim=1)
  score_bar = render.rect_mask(20, 26, 12, 12 + 14 * state.frame_no, dev)
  return render.compose(
      b, dev, (40, 30, 20),
      (c.lane, (150, 120, 80)),
      (pins, (240, 240, 240)),
      (ball, (30, 30, 30)),
      (bowler, (200, 80, 60)),
      (score_bar, (240, 240, 240)),
  )


def bowling_lives(state: BowlingState) -> torch.Tensor:
  return torch.ones_like(state.frame)


GAME = register_game(Game(
    name="bowling",
    num_actions=6,
    init=bowling_init,
    step=bowling_step,
    render=bowling_render,
    lives=bowling_lives,
    init_draws=bowling_init_draws,
    step_draws=bowling_step_draws,
))
