"""Tennis, batched (port of dqn_zoo_tpu/envs/games/tennis.py).

Same constants, update order, float expressions and colours as the
reference: baseline rallies against a scripted opponent that tracks the
ball, +1 a point the opponent fails to return and -1 a point the player
fails to, the episode ends when 24 points are decided or after 20,000
frames, no lives (the reference registers none, so its lives are ones), the
18 joystick actions. The reference's init draws nothing; its step splits a
key carried in the state on every raw frame (a serve's x speed, drawn every
frame and used on a serve only, and the opponent's fumble coin). Here the
state carries no key, `init` takes `TennisInitDraws` (the batch and the
device only) and `step` takes `TennisStepDraws`, the draws of one raw
frame. The game declares `per_frame_draws`, so the vector env hands each
frame of a group and of the noop burn its own.

The returns take the reference's compiled arithmetic (`envs.f32`): XLA
multiplies the contact offset by the f32 reciprocal of the half paddle,
1/7, folds the return's gain into that constant (2.2/7, 2/7) and fuses the
product into its sum with the ball's speed, one multiply-add.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from dqn_zoo_torch.envs import f32, render
from dqn_zoo_torch.envs.api import Game, register_game
from dqn_zoo_torch.envs.games import isin

COURT_TOP, COURT_BOT = 40.0, 190.0
NET_Y = 115.0
COURT_L, COURT_R = 16.0, 144.0
PLAYER_Y = 178.0
OPP_Y = 48.0
PAD_W, PAD_H = 14, 5
PLAYER_SPEED = 2.6
OPP_SPEED = 3.4  # outruns any return; points come from forced fumbles
BALL_SPEED_Y = 2.6
SERVE_DELAY = 40
POINTS_PER_EPISODE = 24
EPISODE_FRAMES = 20000
FUMBLE_PROB = 0.04

_LEFT = (4, 7, 9, 12, 15, 17)
_RIGHT = (3, 6, 8, 11, 14, 16)

# The returns' gains times 1 / (PAD_W / 2), folded into one f32 constant
# as XLA folds them.
_PLAYER_GAIN = float(np.float32(2.2) * np.float32(f32.recip(PAD_W / 2)))
_OPP_GAIN = float(np.float32(2.0) * np.float32(f32.recip(PAD_W / 2)))


class TennisState(NamedTuple):
  px: torch.Tensor  # (B,) f32 player paddle centre x
  ox: torch.Tensor  # (B,) f32 opponent paddle centre x
  bx: torch.Tensor  # (B,) f32
  by: torch.Tensor  # (B,) f32
  bvx: torch.Tensor  # (B,) f32
  bvy: torch.Tensor  # (B,) f32
  serve_timer: torch.Tensor  # (B,) i32 > 0: the ball is dead, a serve soon
  serve_to_player: torch.Tensor  # (B,) bool, the next serve's direction
  points: torch.Tensor  # (B,) i32 decided points
  frame: torch.Tensor  # (B,) i32


class TennisInitDraws(NamedTuple):
  batch: torch.Tensor  # (B,) i32 zeros: no draw, the batch and the device


class TennisStepDraws(NamedTuple):
  serve_vx: torch.Tensor  # (B,) f32 in [-2, 2), a serve's x speed
  miss: torch.Tensor  # (B,) bool, true with FUMBLE_PROB


def tennis_init_draws(gen, b, device) -> TennisInitDraws:
  del gen  # every episode starts alike
  return TennisInitDraws(
      batch=torch.zeros((b,), dtype=torch.int32, device=device))


def tennis_step_draws(gen, b, device, frames: int) -> TennisStepDraws:
  """The serve speeds and fumble coins of `frames` raw frames: (frames, B)
  each."""
  u = torch.rand((frames, b), generator=gen, device=device)
  return TennisStepDraws(
      serve_vx=u * 4.0 - 2.0,
      miss=torch.rand((frames, b), generator=gen, device=device)
      < FUMBLE_PROB)


def tennis_init(draws: TennisInitDraws) -> TennisState:
  b = draws.batch.shape[0]
  dev = draws.batch.device
  f = lambda v: torch.full((b,), v, dtype=torch.float32, device=dev)
  i = lambda v: torch.full((b,), v, dtype=torch.int32, device=dev)
  return TennisState(
      px=f(80.0), ox=f(80.0), bx=f(80.0), by=f(NET_Y), bvx=f(0.0),
      bvy=f(0.0), serve_timer=i(SERVE_DELAY),
      serve_to_player=torch.ones((b,), dtype=torch.bool, device=dev),
      points=i(0), frame=i(0))


def tennis_step(state: TennisState, action: torch.Tensor,
                draws: TennisStepDraws):
  frame = state.frame + 1
  left = isin(action, _LEFT)
  right = isin(action, _RIGHT)
  zero = torch.zeros_like(state.px)
  dx = torch.where(left, -PLAYER_SPEED,
                   torch.where(right, PLAYER_SPEED, zero))
  pad_lo, pad_hi = COURT_L + PAD_W / 2, COURT_R - PAD_W / 2
  px = torch.clamp(state.px + dx, pad_lo, pad_hi)

  # The opponent tracks the ball's x at a bounded speed.
  want = state.bx - state.ox
  ox = state.ox + torch.clamp(want, -OPP_SPEED, OPP_SPEED)
  ox = torch.clamp(ox, pad_lo, pad_hi)

  serving = state.serve_timer > 0
  serve_timer = torch.clamp(state.serve_timer - 1, min=0)
  do_serve = serving & (serve_timer == 0)
  bx = torch.where(do_serve, 80.0, state.bx)
  by = torch.where(do_serve, NET_Y, state.by)
  bvx = torch.where(do_serve, draws.serve_vx.to(torch.float32), state.bvx)
  serve_vy = torch.where(state.serve_to_player, BALL_SPEED_Y, -BALL_SPEED_Y)
  bvy = torch.where(do_serve, serve_vy, state.bvy)

  live = ~serving | do_serve
  bx = bx + torch.where(live, bvx, zero)
  by = by + torch.where(live, bvy, zero)
  hit_wall = (bx < COURT_L) | (bx > COURT_R)
  bvx = torch.where(hit_wall, -bvx, bvx)
  bx = torch.clamp(bx, COURT_L, COURT_R)

  # The player's return: contact at the baseline while the ball comes
  # down, the outgoing angle from the contact offset.
  reach = PAD_W / 2 + 2
  preach = ((by >= PLAYER_Y - 2) & (by <= PLAYER_Y + PAD_H + 2)
            & (torch.abs(bx - px) <= reach) & (bvy > 0) & live)
  bvx = torch.where(preach, torch.clamp(f32.fma(bx - px, _PLAYER_GAIN, bvx),
                                        -3.2, 3.2), bvx)
  bvy = torch.where(preach, -BALL_SPEED_Y, bvy)

  # The opponent's return at the far baseline; it fumbles a fast-angled
  # ball on the drawn coin.
  oreach_geom = ((by <= OPP_Y + PAD_H + 2) & (by >= OPP_Y - 2) & (bvy < 0)
                 & live)
  aligned = torch.abs(bx - ox) <= reach
  fumble = draws.miss & (torch.abs(bvx) > 1.8)
  oreturns = oreach_geom & aligned & ~fumble
  bvx = torch.where(oreturns, torch.clamp(f32.fma(bx - ox, _OPP_GAIN, bvx),
                                          -3.2, 3.2), bvx)
  bvy = torch.where(oreturns, BALL_SPEED_Y, bvy)

  # Points: the ball crosses either baseline.
  opp_point = live & (by > COURT_BOT)  # the player failed to return
  my_point = live & (by < COURT_TOP)  # the opponent failed
  point = opp_point | my_point
  reward = my_point.to(torch.float32) - opp_point.to(torch.float32)
  points = state.points + point.to(torch.int32)
  serve_timer = torch.where(point, SERVE_DELAY, serve_timer).to(torch.int32)
  serve_to_player = torch.where(point, my_point, state.serve_to_player)
  bvx = torch.where(point, zero, bvx)
  bvy = torch.where(point, zero, bvy)
  by = torch.where(point, NET_Y, by)
  bx = torch.where(point, 80.0, bx)

  done = (points >= POINTS_PER_EPISODE) | (frame >= EPISODE_FRAMES)
  new_state = TennisState(px, ox, bx, by, bvx, bvy, serve_timer,
                          serve_to_player, points, frame)
  return new_state, reward, done, torch.zeros_like(done)


@functools.lru_cache(maxsize=None)
def _scenery(device: torch.device) -> tuple:
  """The court's (mask, rgb) layers on `device`, made there once."""
  mask = lambda *box: render.rect_mask(*box, device)
  return ((mask(int(COURT_TOP), int(COURT_BOT), int(COURT_L), int(COURT_R)),
           (60, 140, 90)),
          (mask(int(NET_Y) - 1, int(NET_Y) + 2, int(COURT_L), int(COURT_R)),
           (220, 220, 220)))


def tennis_render(state: TennisState) -> torch.Tensor:
  b = state.px.shape[0]
  dev = state.px.device
  rect = lambda *box: render.rect_mask(*box, dev)
  half = PAD_W / 2
  player = rect(int(PLAYER_Y), int(PLAYER_Y + PAD_H), state.px - half,
                state.px + half)
  opp = rect(int(OPP_Y), int(OPP_Y + PAD_H), state.ox - half,
             state.ox + half)
  ball = rect(state.by - 2, state.by + 2, state.bx - 2, state.bx + 2) \
      & (state.serve_timer == 0)[:, None, None]
  score = rect(20, 26, 16, 16 + 4 * state.points)
  return render.compose(
      b, dev, (40, 100, 60), *_scenery(dev),
      (opp, (210, 90, 70)),
      (player, (90, 120, 220)),
      (ball, (240, 240, 240)),
      (score, (240, 240, 240)),
  )


def tennis_lives(state: TennisState) -> torch.Tensor:
  return torch.ones_like(state.frame)


GAME = register_game(Game(
    name="tennis",
    num_actions=18,
    init=tennis_init,
    step=tennis_step,
    render=tennis_render,
    lives=tennis_lives,
    init_draws=tennis_init_draws,
    step_draws=tennis_step_draws,
    per_frame_draws=True,
))
