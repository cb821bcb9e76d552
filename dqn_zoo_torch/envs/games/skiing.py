"""Skiing, batched (port of dqn_zoo_tpu/envs/games/skiing.py).

Same constants, update order, float expressions and colours as the
reference: a slalom down a 6,000 px course through 20 gates, 3 actions
(NOOP, RIGHT, LEFT), no lives; the only reward comes at the finish, minus
the elapsed centiseconds and 500 for each missed gate. The reference draws
only at init (the gates' columns), from a key carried in the state; here the
state carries no key, `init` takes `SkiingInitDraws`, and a step draws
nothing. The finish's reward is one multiply-add and the posts' edges one
sum each, as XLA compiles the reference's (`envs.f32`).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from dqn_zoo_torch.envs import f32, render
from dqn_zoo_torch.envs.api import Game, register_game

COURSE_LEN = 6000.0  # world px top to bottom
NUM_GATES = 20
GATE_SPACING = COURSE_LEN / (NUM_GATES + 1)
GATE_HALF_W = 12.0  # post centre offset from the gate centre
POST_W, POST_H = 3, 8
SKIER_X_MIN, SKIER_X_MAX = 8.0, 152.0
SKIER_Y = 60  # screen row of the skier
SKIER_W, SKIER_H = 6, 10
SPEED_STRAIGHT = 3.0
SPEED_TURN = 1.2
TURN_RATE = 2.0  # px/frame horizontal carve
CS_PER_FRAME = 100.0 / 60.0  # centiseconds per frame at 60 Hz
MISS_PENALTY_CS = 500.0
TREE_COLOR = (38, 110, 38)
POST_COLOR = (66, 72, 200)
SKIER_COLOR = (214, 92, 92)


class SkiingState(NamedTuple):
  skier_x: torch.Tensor  # (B,) f32, screen x of the skier's centre
  course_y: torch.Tensor  # (B,) f32, world y at the skier's row
  gate_x: torch.Tensor  # (B, NUM_GATES) f32, gate centre x
  gate_passed: torch.Tensor  # (B, NUM_GATES) bool
  gate_judged: torch.Tensor  # (B, NUM_GATES) bool — crossed the skier's row
  frames: torch.Tensor  # (B,) i32


class SkiingInitDraws(NamedTuple):
  gate_x: torch.Tensor  # (B, NUM_GATES) f32 in [28, 132)


def skiing_init_draws(gen, b, device) -> SkiingInitDraws:
  lo, hi = SKIER_X_MIN + 20.0, SKIER_X_MAX - 20.0
  u = torch.rand((b, NUM_GATES), generator=gen, device=device)
  return SkiingInitDraws(gate_x=u * (hi - lo) + lo)


def skiing_step_draws(gen, b, device) -> None:
  del gen, b, device  # a step consumes no random number


def skiing_init(draws: SkiingInitDraws) -> SkiingState:
  b = draws.gate_x.shape[0]
  dev = draws.gate_x.device
  gates = (b, NUM_GATES)
  return SkiingState(
      skier_x=torch.full((b,), 80.0, dtype=torch.float32, device=dev),
      course_y=torch.zeros((b,), dtype=torch.float32, device=dev),
      gate_x=draws.gate_x.to(torch.float32),
      gate_passed=torch.zeros(gates, dtype=torch.bool, device=dev),
      gate_judged=torch.zeros(gates, dtype=torch.bool, device=dev),
      frames=torch.zeros((b,), dtype=torch.int32, device=dev),
  )


class _Tables(NamedTuple):
  gate_y: torch.Tensor  # (1, NUM_GATES) f32, the gates' world y
  rows: torch.Tensor  # (210,) i32
  cols: torch.Tensor  # (160,) i32
  trees: torch.Tensor  # (210, 160) bool


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> _Tables:
  """The step's and the render's constant tensors on `device`, copied there
  once."""
  t = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
  mask = lambda *box: render.rect_mask(*box, device)
  return _Tables(
      gate_y=((torch.arange(NUM_GATES, dtype=torch.float32, device=device)
               + 1.0) * t(GATE_SPACING))[None, :],
      rows=torch.arange(210, dtype=torch.int32, device=device),
      cols=torch.arange(160, dtype=torch.int32, device=device),
      trees=(mask(0, 210, 0, int(SKIER_X_MIN) - 2)
             | mask(0, 210, int(SKIER_X_MAX) + 2, 160)))


def skiing_step(state: SkiingState, action: torch.Tensor, draws=None):
  del draws
  c = _tables(state.skier_x.device)
  right = action == 1
  left = action == 2
  turning = right | left
  zero = torch.zeros_like(state.skier_x)
  dx = (torch.where(right, TURN_RATE, zero)
        - torch.where(left, TURN_RATE, zero))
  sx = torch.clamp(state.skier_x + dx, SKIER_X_MIN, SKIER_X_MAX)
  vy = torch.where(turning, SPEED_TURN, SPEED_STRAIGHT).to(torch.float32)
  cy = state.course_y + vy

  # Judge each gate on the frame its world y crosses the skier's row.
  crossing = ~state.gate_judged & (c.gate_y <= cy[:, None])
  within = torch.abs(state.gate_x - sx[:, None]) <= GATE_HALF_W
  passed = state.gate_passed | (crossing & within)
  judged = state.gate_judged | crossing

  frames = state.frames + 1
  done = cy >= COURSE_LEN
  missed = (~passed).to(torch.float32).sum(dim=1)  # unjudged count as missed
  elapsed_plus_misses = f32.fma(frames.to(torch.float32), CS_PER_FRAME,
                                MISS_PENALTY_CS * missed)
  reward = torch.where(done, -elapsed_plus_misses, zero)

  new_state = SkiingState(sx, cy, state.gate_x, passed, judged, frames)
  return new_state, reward, done, torch.zeros_like(done)


def skiing_render(state: SkiingState) -> torch.Tensor:
  b = state.skier_x.shape[0]
  dev = state.skier_x.device
  c = _tables(dev)
  # The two posts of each gate still below the skier and on screen.
  screen_y = SKIER_Y + (c.gate_y - state.course_y[:, None])  # (B, NUM_GATES)
  shown = (screen_y >= 0.0) & (screen_y < 204.0) & ~state.gate_judged
  y0 = screen_y.to(torch.int32)[..., None]
  y1 = (screen_y + POST_H).to(torch.int32)[..., None]
  post_rows = (c.rows >= y0) & (c.rows < y1) & shown[..., None]
  post_cols = torch.zeros((b, NUM_GATES, 160), dtype=torch.bool, device=dev)
  for sign in (-1.0, 1.0):
    centre = sign * GATE_HALF_W  # the post's centre, from the gate's
    x0 = (state.gate_x + (centre - POST_W / 2)).to(torch.int32)[..., None]
    x1 = (state.gate_x + (centre + POST_W / 2)).to(torch.int32)[..., None]
    post_cols = post_cols | ((c.cols >= x0) & (c.cols < x1))
  # The union over gates of their rows x columns, as a product of 0/1
  # matrices: each sum counts at most 40 ones, exact in f32.
  posts = torch.bmm(post_rows.transpose(1, 2).to(torch.float32),
                    post_cols.to(torch.float32)) > 0
  skier = render.rect_mask(SKIER_Y, SKIER_Y + SKIER_H,
                           state.skier_x - SKIER_W / 2,
                           state.skier_x + SKIER_W / 2, dev)
  return render.compose(b, dev, (236, 236, 236),
                        (c.trees, TREE_COLOR),
                        (posts, POST_COLOR),
                        (skier, SKIER_COLOR))


def skiing_lives(state: SkiingState) -> torch.Tensor:
  return torch.ones_like(state.frames)


GAME = register_game(Game(
    name="skiing",
    num_actions=3,
    init=skiing_init,
    step=skiing_step,
    render=skiing_render,
    lives=skiing_lives,
    init_draws=skiing_init_draws,
    step_draws=skiing_step_draws,
))
