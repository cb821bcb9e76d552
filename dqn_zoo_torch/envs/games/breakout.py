"""Breakout, batched (port of dqn_zoo_tpu/envs/games/breakout.py).

Same constants, update order, float expressions and colours as the
reference: paddle and ball, a 6 x 18 brick wall scored by row, 5 lives, a
serve from just below the wall at a random column. The reference draws from
a key carried in the state at init (the paddle's start) and at a serve,
advancing the key only when it serves; here the state carries no key,
`init` takes `BreakoutInitDraws` and `step` takes `BreakoutStepDraws`. A
served ball starts 108 px above the life-loss line, moving down at 3 px a
frame, so an env serves at most once in an action-repeat group (4 frames)
and none in the noop burn (a serve needs FIRE or 120 idle frames): one draw
set a group covers it.

The grid lookup takes the reference's compiled arithmetic (`envs.f32`):
XLA folds `cy - BRICK_TOP` after `cy = by + 1` into `by - 56` and divides
by a constant as a product with its f32 reciprocal, so the floor picks the
reference's brick on the CPU and on the card.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from dqn_zoo_torch.envs import f32, render
from dqn_zoo_torch.envs.api import Game, register_game

ROWS, COLS = 6, 18
BRICK_H, BRICK_W = 6, 8
BRICK_TOP = 57
BRICK_LEFT = 8
TOP = 32
PADDLE_Y = 189
PADDLE_W = 16
PADDLE_H = 4
BALL = 2
PADDLE_SPEED = 6.0
LIVES = 5
ROW_POINTS = (7.0, 7.0, 4.0, 4.0, 1.0, 1.0)  # top row first
ROW_COLORS = ((200, 72, 72), (198, 108, 58), (180, 122, 48), (162, 162, 42),
              (72, 160, 72), (66, 72, 200))
SERVE_Y = float(BRICK_TOP + ROWS * BRICK_H + 4)


class BreakoutState(NamedTuple):
  paddle_x: torch.Tensor  # (B,) f32, left edge
  ball_x: torch.Tensor  # (B,) f32
  ball_y: torch.Tensor  # (B,) f32
  ball_vx: torch.Tensor  # (B,) f32
  ball_vy: torch.Tensor  # (B,) f32
  bricks: torch.Tensor  # (B, ROWS, COLS) bool
  lives: torch.Tensor  # (B,) i32
  ball_dead: torch.Tensor  # (B,) bool — waiting for a serve
  serve_delay: torch.Tensor  # (B,) i32


class BreakoutInitDraws(NamedTuple):
  paddle_x: torch.Tensor  # (B,) f32 in [8, 152 - PADDLE_W)


class BreakoutStepDraws(NamedTuple):
  serve_right: torch.Tensor  # (B,) bool — a serve moves right (vx = +1.5)
  serve_x: torch.Tensor  # (B,) f32 in [12, 148 - BALL), the serve's column


def _uniform(gen, shape, device, lo, hi):
  return torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo


def breakout_init_draws(gen, b, device) -> BreakoutInitDraws:
  return BreakoutInitDraws(
      paddle_x=_uniform(gen, (b,), device, 8.0, 152.0 - PADDLE_W))


def breakout_step_draws(gen, b, device) -> BreakoutStepDraws:
  return BreakoutStepDraws(
      serve_right=torch.rand((b,), generator=gen, device=device) < 0.5,
      serve_x=_uniform(gen, (b,), device, 12.0, 148.0 - BALL))


def breakout_init(draws: BreakoutInitDraws) -> BreakoutState:
  b = draws.paddle_x.shape[0]
  dev = draws.paddle_x.device
  f = lambda v: torch.full((b,), v, dtype=torch.float32, device=dev)
  return BreakoutState(
      paddle_x=draws.paddle_x.to(torch.float32),
      ball_x=f(80.0),
      ball_y=f(120.0),
      ball_vx=f(1.5),
      ball_vy=f(-3.0),
      bricks=torch.ones((b, ROWS, COLS), dtype=torch.bool, device=dev),
      lives=torch.full((b,), LIVES, dtype=torch.int32, device=dev),
      ball_dead=torch.ones((b,), dtype=torch.bool, device=dev),
      serve_delay=torch.zeros((b,), dtype=torch.int32, device=dev),
  )


class _Tables(NamedTuple):
  row_points: torch.Tensor  # (ROWS,) f32
  cell_rows: torch.Tensor  # (1, ROWS, 1) i64
  cell_cols: torch.Tensor  # (1, 1, COLS) i64
  cell_of_pixel: torch.Tensor  # (210, 160) i64, brick cell under a pixel
  row_bands: torch.Tensor  # (ROWS, 210, 160) bool, brick row r's pixels
  walls: torch.Tensor  # (210, 160) bool


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> _Tables:
  """The step's and the render's constant tensors on `device`, copied there
  once."""
  rows = torch.arange(210, device=device)[:, None]
  cols = torch.arange(160, device=device)[None, :]
  r = (rows - BRICK_TOP).div(BRICK_H, rounding_mode="floor")
  c = (cols - BRICK_LEFT).div(BRICK_W, rounding_mode="floor")
  in_wall = (r >= 0) & (r < ROWS) & (c >= 0) & (c < COLS)
  cell = torch.where(in_wall, r.clamp(0, ROWS - 1) * COLS
                     + c.clamp(0, COLS - 1), 0)
  bands = torch.stack([in_wall & (r == i) for i in range(ROWS)])
  walls = (render.rect_mask(17, 32, 0, 160, device)
           | render.rect_mask(32, 196, 0, 8, device)
           | render.rect_mask(32, 196, 152, 160, device))
  return _Tables(
      row_points=torch.tensor(ROW_POINTS, dtype=torch.float32,
                              device=device),
      cell_rows=torch.arange(ROWS, device=device)[None, :, None],
      cell_cols=torch.arange(COLS, device=device)[None, None, :],
      cell_of_pixel=cell, row_bands=bands, walls=walls)


def breakout_step(state: BreakoutState, action: torch.Tensor,
                  draws: BreakoutStepDraws):
  c = _tables(state.paddle_x.device)
  right = action == 2
  left = action == 3
  fire = action == 1
  zero = torch.zeros_like(state.paddle_x)
  dx = torch.where(right, PADDLE_SPEED,
                   torch.where(left, -PADDLE_SPEED, zero))
  paddle_x = torch.clamp(state.paddle_x + dx, 8.0, 152.0 - PADDLE_W)

  # Serve: FIRE launches a dead ball (or it launches after 120 frames), just
  # below the wall at a random column, moving down.
  serve_delay = state.serve_delay + state.ball_dead.to(torch.int32)
  do_serve = state.ball_dead & (fire | (serve_delay > 120))
  svx = torch.where(draws.serve_right, 1.5, -1.5).to(torch.float32)
  ball_dead = state.ball_dead & ~do_serve
  bx = torch.where(do_serve, draws.serve_x.to(torch.float32), state.ball_x)
  by = torch.where(do_serve, SERVE_Y, state.ball_y)
  vx = torch.where(do_serve, svx, state.ball_vx)
  vy = torch.where(do_serve, 3.0, state.ball_vy)
  serve_delay = torch.where(do_serve, 0, serve_delay).to(torch.int32)

  live = ~ball_dead
  bx = bx + torch.where(live, vx, zero)
  by = by + torch.where(live, vy, zero)

  # Side and top walls.
  hit_side = (bx < 8.0) | (bx > 152.0 - BALL)
  vx = torch.where(hit_side, -vx, vx)
  bx = torch.clamp(bx, 8.0, 152.0 - BALL)
  hit_top = by < TOP
  vy = torch.where(hit_top, -vy, vy)
  by = torch.where(hit_top, float(TOP), by)

  # Brick collision: the ball's centre (bx + 1, by + 1) mapped to a grid
  # cell, in the reference's compiled form.
  cx = bx + BALL / 2
  col = torch.floor((bx + (BALL / 2 - BRICK_LEFT))
                    * f32.recip(BRICK_W)).to(torch.int32)
  row = torch.floor((by + (BALL / 2 - BRICK_TOP))
                    * f32.recip(BRICK_H)).to(torch.int32)
  in_grid = (row >= 0) & (row < ROWS) & (col >= 0) & (col < COLS) & live
  rc = torch.clamp(row, 0, ROWS - 1).long()
  cc = torch.clamp(col, 0, COLS - 1).long()
  cell = (c.cell_rows == rc[:, None, None]) & (c.cell_cols == cc[:, None, None])
  brick_here = in_grid & (state.bricks & cell).flatten(1).any(dim=1)
  bricks = state.bricks & ~(cell & brick_here[:, None, None])
  vy = torch.where(brick_here, -vy, vy)
  reward = torch.where(brick_here, c.row_points[rc], zero)

  # Wall cleared: a new wall (ALE serves a second one).
  cleared = ~bricks.flatten(1).any(dim=1)
  bricks = bricks | cleared[:, None, None]

  # Paddle bounce.
  on_paddle = (by + BALL >= PADDLE_Y) & (by <= PADDLE_Y + PADDLE_H) & \
      (bx + BALL >= paddle_x) & (bx <= paddle_x + PADDLE_W) & (vy > 0)
  offset = (cx - (paddle_x + PADDLE_W / 2)) * f32.recip(PADDLE_W / 2)
  vx = torch.where(on_paddle, torch.clamp(vx + 2.0 * offset, -4.0, 4.0), vx)
  vy = torch.where(on_paddle, -torch.abs(vy) - 0.02, vy)
  vy = torch.clamp(vy, -5.0, 5.0)
  by = torch.where(on_paddle, float(PADDLE_Y - BALL), by)

  # Life loss: the ball falls past the paddle.
  lost = live & (by > 205.0)
  lives = state.lives - lost.to(torch.int32)
  ball_dead = ball_dead | lost
  done = lives <= 0

  new_state = BreakoutState(paddle_x, bx, by, vx, vy, bricks, lives,
                            ball_dead, serve_delay)
  life_lost = lost & ~done  # the terminal step reports done, not life loss
  return new_state, reward, done, life_lost


def breakout_render(state: BreakoutState) -> torch.Tensor:
  b = state.paddle_x.shape[0]
  dev = state.paddle_x.device
  c = _tables(dev)
  # A pixel of the wall band shows its brick where that brick stands.
  bricks = state.bricks.flatten(1)[:, c.cell_of_pixel]  # (B, 210, 160)
  rows = [(bricks & c.row_bands[i], ROW_COLORS[i]) for i in range(ROWS)]
  paddle = render.rect_mask(PADDLE_Y, PADDLE_Y + PADDLE_H, state.paddle_x,
                            state.paddle_x + PADDLE_W, dev)
  ball = render.rect_mask(state.ball_y, state.ball_y + BALL, state.ball_x,
                          state.ball_x + BALL, dev)
  return render.compose(
      b, dev, (0, 0, 0),
      (c.walls, (142, 142, 142)),
      *rows,
      (paddle, (200, 72, 72)),
      (ball, (200, 72, 72)),
  )


def breakout_lives(state: BreakoutState) -> torch.Tensor:
  return state.lives


GAME = register_game(Game(
    name="breakout",
    num_actions=4,
    init=breakout_init,
    step=breakout_step,
    render=breakout_render,
    lives=breakout_lives,
    init_draws=breakout_init_draws,
    step_draws=breakout_step_draws,
))
