"""Catch, batched (port of dqn_zoo_tpu/envs/games/catch.py).

One ball falls from the top in a random column; move the paddle under it.
Reward +1 on a catch, −1 on a miss; the episode ends after one drop. Three
actions (NOOP, LEFT, RIGHT). The reference draws the ball's column and the
paddle's start at init from a key carried in the state; here `init` takes
`CatchInitDraws`. A step draws nothing.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dqn_zoo_torch.envs import render
from dqn_zoo_torch.envs.api import Game, register_game

COLS = 5
CELL_W = 32  # 5 × 32 = 160
BALL_SIZE = 16
PADDLE_Y = 190
FALL_SPEED = 2.0
# Columns per RAW frame: under action repeat 4 one agent-step moves exactly
# one column, so every column stays reachable.
PADDLE_SPEED = 0.25


class CatchState(NamedTuple):
  ball_col: torch.Tensor  # (B,) i32
  ball_y: torch.Tensor  # (B,) f32
  paddle_pos: torch.Tensor  # (B,) f32, column position (rounded to catch)


class CatchInitDraws(NamedTuple):
  ball_col: torch.Tensor  # (B,) int in [0, COLS)
  paddle_pos: torch.Tensor  # (B,) int in [0, COLS)


def catch_init_draws(gen, b, device) -> CatchInitDraws:
  return CatchInitDraws(
      ball_col=torch.randint(0, COLS, (b,), generator=gen, device=device,
                             dtype=torch.int32),
      paddle_pos=torch.randint(0, COLS, (b,), generator=gen, device=device,
                               dtype=torch.int32))


def catch_step_draws(gen, b, device) -> None:
  del gen, b, device  # a step consumes no random number


def catch_init(draws: CatchInitDraws) -> CatchState:
  col = draws.ball_col.to(torch.int32)
  return CatchState(
      ball_col=col,
      ball_y=torch.full(col.shape, 20.0, dtype=torch.float32,
                        device=col.device),
      paddle_pos=draws.paddle_pos.to(torch.float32))


def catch_step(state: CatchState, action: torch.Tensor, draws=None):
  del draws
  zero = torch.zeros_like(state.paddle_pos)
  move = torch.where(action == 1, -PADDLE_SPEED,
                     torch.where(action == 2, PADDLE_SPEED, zero))
  paddle_pos = torch.clamp(state.paddle_pos + move, 0.0, COLS - 1.0)
  ball_y = state.ball_y + FALL_SPEED
  done = ball_y >= PADDLE_Y
  caught = done & (torch.round(paddle_pos).to(torch.int32) == state.ball_col)
  reward = torch.where(done, torch.where(caught, 1.0, -1.0), zero)
  return (CatchState(state.ball_col, ball_y, paddle_pos), reward, done,
          torch.zeros_like(done))


def catch_render(state: CatchState) -> torch.Tensor:
  b = state.ball_y.shape[0]
  dev = state.ball_y.device
  ball_x = state.ball_col * CELL_W + (CELL_W - BALL_SIZE) // 2
  paddle_x = state.paddle_pos * CELL_W
  ball = render.rect_mask(state.ball_y, state.ball_y + BALL_SIZE, ball_x,
                          ball_x + BALL_SIZE, dev)
  paddle = render.rect_mask(PADDLE_Y, PADDLE_Y + 8, paddle_x,
                            paddle_x + CELL_W, dev)
  return render.compose(b, dev, (0, 0, 0),
                        (ball, (236, 236, 236)),
                        (paddle, (92, 186, 92)))


def catch_lives(state: CatchState) -> torch.Tensor:
  return torch.ones_like(state.ball_col)


GAME = register_game(Game(
    name="catch",
    num_actions=3,
    init=catch_init,
    step=catch_step,
    render=catch_render,
    lives=catch_lives,
    init_draws=catch_init_draws,
    step_draws=catch_step_draws,
))
