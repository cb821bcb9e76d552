"""Pong, batched (port of dqn_zoo_tpu/envs/games/pong.py).

Same geometry, dynamics and colours as the reference. The reference draws
random numbers at init and at every serve from a key carried in the state;
here the state carries no key, `init` takes `PongInitDraws` and `step` takes
`PongStepDraws`. A serve leaves the ball still for 30 frames, so one
action-repeat group (4 frames) holds at most one serve per env and one
`serve_vy` per env covers it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dqn_zoo_torch.envs import render
from dqn_zoo_torch.envs.api import Game, register_game

TOP = 34
BOTTOM = 194
PADDLE_H = 16
PADDLE_W = 4
BALL = 4
PLAYER_X = 140.0
ENEMY_X = 16.0
PLAYER_SPEED = 4.0
ENEMY_SPEED = 3.0
BALL_SPEED_X = 3.0
WIN_SCORE = 21


class PongState(NamedTuple):
  player_y: torch.Tensor  # (B,) f32, paddle top
  enemy_y: torch.Tensor
  ball_x: torch.Tensor
  ball_y: torch.Tensor
  ball_vx: torch.Tensor
  ball_vy: torch.Tensor
  player_score: torch.Tensor  # (B,) i32
  enemy_score: torch.Tensor  # (B,) i32
  serve_delay: torch.Tensor  # (B,) i32, frames until the ball is live


class PongInitDraws(NamedTuple):
  toward_player: torch.Tensor  # (B,) bool — first serve direction
  serve_vy: torch.Tensor  # (B,) f32 in [-2, 2)
  ball_y: torch.Tensor  # (B,) f32 in [TOP + 20, BOTTOM - 24)
  serve_delay: torch.Tensor  # (B,) i32 in [2, 12)


class PongStepDraws(NamedTuple):
  serve_vy: torch.Tensor  # (B,) f32 in [-2, 2), used where a point is scored


def _uniform(gen, b, device, lo, hi):
  return torch.rand((b,), generator=gen, device=device) * (hi - lo) + lo


def pong_init_draws(gen, b, device) -> PongInitDraws:
  return PongInitDraws(
      toward_player=torch.rand((b,), generator=gen, device=device) < 0.5,
      serve_vy=_uniform(gen, b, device, -2.0, 2.0),
      ball_y=_uniform(gen, b, device, float(TOP) + 20.0,
                      float(BOTTOM) - 24.0),
      serve_delay=torch.randint(2, 12, (b,), generator=gen, device=device,
                                dtype=torch.int32),
  )


def pong_step_draws(gen, b, device) -> PongStepDraws:
  return PongStepDraws(serve_vy=_uniform(gen, b, device, -2.0, 2.0))


def pong_init(draws: PongInitDraws) -> PongState:
  b = draws.ball_y.shape[0]
  dev = draws.ball_y.device
  mid = torch.full((b,), (TOP + BOTTOM) / 2 - PADDLE_H / 2, dtype=torch.float32,
                   device=dev)
  zeros_i = torch.zeros((b,), dtype=torch.int32, device=dev)
  return PongState(
      player_y=mid,
      enemy_y=mid.clone(),
      ball_x=torch.full((b,), 80.0, dtype=torch.float32, device=dev),
      ball_y=draws.ball_y.to(torch.float32),
      ball_vx=torch.where(draws.toward_player, BALL_SPEED_X,
                          -BALL_SPEED_X).to(torch.float32),
      ball_vy=draws.serve_vy.to(torch.float32),
      player_score=zeros_i,
      enemy_score=zeros_i.clone(),
      serve_delay=draws.serve_delay.to(torch.int32),
  )


def pong_step(state: PongState, action: torch.Tensor, draws: PongStepDraws):
  up = (action == 2) | (action == 4)
  down = (action == 3) | (action == 5)
  zero = torch.zeros_like(state.player_y)
  dy = torch.where(up, -PLAYER_SPEED,
                   torch.where(down, PLAYER_SPEED, zero))
  player_y = torch.clamp(state.player_y + dy, TOP, BOTTOM - PADDLE_H)

  target = state.ball_y - PADDLE_H / 2
  diff = target - state.enemy_y
  edy = torch.clamp(diff, -ENEMY_SPEED, ENEMY_SPEED)
  edy = torch.where(torch.abs(diff) < 2.0, zero, edy)
  enemy_y = torch.clamp(state.enemy_y + edy, TOP, BOTTOM - PADDLE_H)

  live = state.serve_delay <= 0
  serve_delay = torch.clamp(state.serve_delay - 1, min=0)
  bx = state.ball_x + torch.where(live, state.ball_vx, zero)
  by = state.ball_y + torch.where(live, state.ball_vy, zero)
  vx, vy = state.ball_vx, state.ball_vy

  hit_top = by < TOP
  hit_bot = by > BOTTOM - BALL
  vy = torch.where(hit_top | hit_bot, -vy, vy)
  by = torch.clamp(by, TOP, BOTTOM - BALL)

  overlap_p = (bx + BALL >= PLAYER_X) & (bx <= PLAYER_X + PADDLE_W) & \
      (by + BALL >= player_y) & (by <= player_y + PADDLE_H) & (vx > 0)
  offset_p = (by + BALL / 2 - (player_y + PADDLE_H / 2)) / (PADDLE_H / 2)
  vy = torch.where(overlap_p, torch.clamp(vy + 2.0 * offset_p, -4.0, 4.0), vy)
  vx = torch.where(overlap_p, -torch.clamp(torch.abs(vx) + 0.15, max=5.0), vx)
  bx = torch.where(overlap_p, zero + (PLAYER_X - BALL), bx)

  overlap_e = (bx <= ENEMY_X + PADDLE_W) & (bx + BALL >= ENEMY_X) & \
      (by + BALL >= enemy_y) & (by <= enemy_y + PADDLE_H) & (vx < 0)
  offset_e = (by + BALL / 2 - (enemy_y + PADDLE_H / 2)) / (PADDLE_H / 2)
  vy = torch.where(overlap_e, torch.clamp(vy + 2.0 * offset_e, -4.0, 4.0), vy)
  vx = torch.where(overlap_e, torch.clamp(torch.abs(vx) + 0.15, max=5.0), vx)
  bx = torch.where(overlap_e, zero + (ENEMY_X + PADDLE_W), bx)

  player_point = bx < 0.0
  enemy_point = bx > 160.0 - BALL
  reward = torch.where(player_point, 1.0,
                       torch.where(enemy_point, -1.0, zero))
  player_score = state.player_score + player_point.to(torch.int32)
  enemy_score = state.enemy_score + enemy_point.to(torch.int32)

  scored = player_point | enemy_point
  # Serve toward the scorer's foe: toward the player after an enemy point.
  svx = torch.where(enemy_point, BALL_SPEED_X, -BALL_SPEED_X).to(torch.float32)
  bx = torch.where(scored, zero + 80.0, bx)
  by = torch.where(scored, zero + (TOP + BOTTOM) / 2.0, by)
  vx = torch.where(scored, svx, vx)
  vy = torch.where(scored, draws.serve_vy.to(torch.float32), vy)
  serve_delay = torch.where(scored, torch.full_like(serve_delay, 30),
                            serve_delay)

  done = (player_score >= WIN_SCORE) | (enemy_score >= WIN_SCORE)
  new_state = PongState(player_y, enemy_y, bx, by, vx, vy, player_score,
                        enemy_score, serve_delay)
  return new_state, reward, done, torch.zeros_like(done)


def pong_render(state: PongState) -> torch.Tensor:
  b = state.player_y.shape[0]
  dev = state.player_y.device
  bg = (144, 72, 17)  # ALE pong brown background
  wall = render.rect_mask(24, TOP, 0, 160, dev) | render.rect_mask(
      BOTTOM, 200, 0, 160, dev)
  player = render.rect_mask(state.player_y, state.player_y + PADDLE_H,
                            torch.full_like(state.player_y, PLAYER_X),
                            torch.full_like(state.player_y,
                                            PLAYER_X + PADDLE_W), dev)
  enemy = render.rect_mask(state.enemy_y, state.enemy_y + PADDLE_H,
                           torch.full_like(state.enemy_y, ENEMY_X),
                           torch.full_like(state.enemy_y,
                                           ENEMY_X + PADDLE_W), dev)
  ball = render.rect_mask(state.ball_y, state.ball_y + BALL,
                          state.ball_x, state.ball_x + BALL, dev)
  return render.compose(
      b, dev, bg,
      (wall, (236, 236, 236)),
      (enemy, (213, 130, 74)),
      (player, (92, 186, 92)),
      (ball, (236, 236, 236)),
  )


def pong_lives(state: PongState) -> torch.Tensor:
  return torch.ones_like(state.player_score)


GAME = register_game(Game(
    name="pong",
    num_actions=6,
    init=pong_init,
    step=pong_step,
    render=pong_render,
    lives=pong_lives,
    init_draws=pong_init_draws,
    step_draws=pong_step_draws,
))
