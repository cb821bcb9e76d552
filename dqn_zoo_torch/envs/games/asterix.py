"""Asterix, batched (port of dqn_zoo_tpu/envs/games/asterix.py).

Same constants, update order, float expressions and colours as the
reference: collect objects crossing eight lanes (+50), dodge the lyres (3
lives), 9 actions (the 8 directions and NOOP), objects faster as the score
grows. The reference splits a key carried in the state at init (start
columns, object kinds) and on every raw frame (a respawn test and a kind
for each lane); here the state carries no key, `init` takes
`AsterixInitDraws` and `step` takes `AsterixStepDraws`, the draws of one raw
frame. The game declares `per_frame_draws`, so the vector env hands each
frame of a group and of the noop burn its own. The speed ramp is one
multiply-add, as XLA compiles the reference's (`envs.f32`).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from dqn_zoo_torch.envs import f32, render
from dqn_zoo_torch.envs.api import Game, register_game

NUM_LANES = 8
LANE_TOP = 30
LANE_H = 18
FIELD_BOTTOM = LANE_TOP + NUM_LANES * LANE_H  # 174
LEFT_WALL, RIGHT_WALL = 12.0, 148.0
PLAYER_W, PLAYER_H = 8, 10
PLAYER_SPEED = 2.0
OBJ_W, OBJ_H = 8, 8
LYRE_PROB = 0.25  # a spawn is a lyre with this probability
SPAWN_PROB = 0.03  # per idle lane per raw frame
BASE_SPEED = 1.0
SPEED_RAMP = 0.0002  # extra px/frame per point scored (capped)
MAX_SPEED = 3.0
POINTS = 50.0
LIVES = 3
RESPAWN_FRAMES = 45
COLLECT_COLOR = (210, 164, 74)  # cauldron gold
LYRE_COLOR = (184, 50, 50)
PLAYER_COLOR = (236, 236, 236)
LANE_TOPS = tuple(LANE_TOP + i * LANE_H + (LANE_H - OBJ_H) // 2
                  for i in range(NUM_LANES))
LANE_DIRS = tuple(1.0 if i % 2 == 0 else -1.0 for i in range(NUM_LANES))


class AsterixState(NamedTuple):
  player_x: torch.Tensor  # (B,) f32, left edge
  player_y: torch.Tensor  # (B,) f32, top edge
  obj_x: torch.Tensor  # (B, NUM_LANES) f32
  obj_live: torch.Tensor  # (B, NUM_LANES) bool
  obj_is_lyre: torch.Tensor  # (B, NUM_LANES) bool
  score: torch.Tensor  # (B,) f32 — drives the speed ramp
  lives: torch.Tensor  # (B,) i32
  respawn_delay: torch.Tensor  # (B,) i32 — invulnerable after a lyre hit


class AsterixInitDraws(NamedTuple):
  obj_x: torch.Tensor  # (B, NUM_LANES) f32 in [12, 148 - OBJ_W)
  lyre_u: torch.Tensor  # (B, NUM_LANES) U[0, 1): a lyre where < 0.25


class AsterixStepDraws(NamedTuple):
  spawn_u: torch.Tensor  # (B, NUM_LANES) U[0, 1): an idle lane spawns < 0.03
  lyre_u: torch.Tensor  # (B, NUM_LANES) U[0, 1): the spawn is a lyre < 0.25


def asterix_init_draws(gen, b, device) -> AsterixInitDraws:
  u = torch.rand((b, NUM_LANES), generator=gen, device=device)
  return AsterixInitDraws(
      obj_x=u * (RIGHT_WALL - OBJ_W - LEFT_WALL) + LEFT_WALL,
      lyre_u=torch.rand((b, NUM_LANES), generator=gen, device=device))


def asterix_step_draws(gen, b, device, frames: int) -> AsterixStepDraws:
  """The lane draws of `frames` raw frames: (frames, B, NUM_LANES) each."""
  shape = (frames, b, NUM_LANES)
  return AsterixStepDraws(
      spawn_u=torch.rand(shape, generator=gen, device=device),
      lyre_u=torch.rand(shape, generator=gen, device=device))


def asterix_init(draws: AsterixInitDraws) -> AsterixState:
  b = draws.obj_x.shape[0]
  dev = draws.obj_x.device
  f = lambda v: torch.full((b,), v, dtype=torch.float32, device=dev)
  i = lambda v: torch.full((b,), v, dtype=torch.int32, device=dev)
  return AsterixState(
      player_x=f(76.0),
      player_y=f(LANE_TOP + (NUM_LANES // 2) * LANE_H + 4.0),
      obj_x=draws.obj_x.to(torch.float32),
      obj_live=torch.ones((b, NUM_LANES), dtype=torch.bool, device=dev),
      obj_is_lyre=draws.lyre_u < LYRE_PROB,
      score=f(0.0),
      lives=i(LIVES),
      respawn_delay=i(0),
  )


class _Tables(NamedTuple):
  lane_dirs: torch.Tensor  # (1, NUM_LANES) f32
  lane_y: torch.Tensor  # (1, NUM_LANES) f32, object tops
  entry: torch.Tensor  # (1, NUM_LANES) f32, x where a spawn enters
  lane_of_row: torch.Tensor  # (210,) i64, the lane whose objects span a row
  row_in_lane: torch.Tensor  # (210, 1) bool, a row some lane's objects span
  border: torch.Tensor  # (210, 160) bool


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> _Tables:
  """The step's and the render's constant tensors on `device`, copied there
  once."""
  t = lambda v: torch.tensor(v, dtype=torch.float32, device=device)[None, :]
  lane_dirs = t(LANE_DIRS)
  rows = torch.arange(210, device=device)
  spans = torch.stack([(rows >= y) & (rows < y + OBJ_H) for y in LANE_TOPS])
  mask = lambda *box: render.rect_mask(*box, device)
  return _Tables(
      lane_dirs=lane_dirs, lane_y=t(LANE_TOPS),
      entry=torch.where(lane_dirs > 0, -float(OBJ_W) + 1.0, 159.0),
      lane_of_row=spans.to(torch.uint8).argmax(dim=0),
      row_in_lane=spans.any(dim=0)[:, None],
      border=(mask(0, LANE_TOP, 0, 160) | mask(FIELD_BOTTOM, 210, 0, 160)
              | mask(0, 210, 0, int(LEFT_WALL) - 4)
              | mask(0, 210, int(RIGHT_WALL) + 4, 160)))


def asterix_step(state: AsterixState, action: torch.Tensor,
                 draws: AsterixStepDraws):
  c = _tables(state.player_x.device)
  # 0 NOOP, 1 UP, 2 RIGHT, 3 LEFT, 4 DOWN, 5 UPRIGHT, 6 UPLEFT, 7 DOWNRIGHT,
  # 8 DOWNLEFT (ALE's minimal set for Asterix).
  up = (action == 1) | (action == 5) | (action == 6)
  down = (action == 4) | (action == 7) | (action == 8)
  right = (action == 2) | (action == 5) | (action == 7)
  left = (action == 3) | (action == 6) | (action == 8)
  zero = torch.zeros_like(state.player_x)
  dx = (torch.where(right, PLAYER_SPEED, zero)
        - torch.where(left, PLAYER_SPEED, zero))
  dy = (torch.where(down, PLAYER_SPEED, zero)
        - torch.where(up, PLAYER_SPEED, zero))
  px = torch.clamp(state.player_x + dx, LEFT_WALL, RIGHT_WALL - PLAYER_W)
  py = torch.clamp(state.player_y + dy, float(LANE_TOP),
                   float(FIELD_BOTTOM - PLAYER_H))

  # Objects drift along their lanes, faster with the score. Objects off the
  # field die; a dead lane respawns at its entry edge with a new kind.
  speed = torch.clamp(f32.fma(state.score, SPEED_RAMP, BASE_SPEED),
                      max=MAX_SPEED)
  ox = state.obj_x + c.lane_dirs * speed[:, None]
  off = (ox < -float(OBJ_W)) | (ox > 160.0)
  live = state.obj_live & ~off
  do_spawn = ~live & (draws.spawn_u < SPAWN_PROB)
  ox = torch.where(do_spawn, c.entry, ox)
  is_lyre = torch.where(do_spawn, draws.lyre_u < LYRE_PROB, state.obj_is_lyre)
  live = live | do_spawn

  # The player against the object of each lane.
  lane_y = c.lane_y
  yy, xx = py[:, None], px[:, None]
  oy_overlap = (yy + PLAYER_H >= lane_y) & (yy <= lane_y + OBJ_H)
  ox_overlap = (ox <= xx + PLAYER_W) & (ox + OBJ_W >= xx)
  touch = live & oy_overlap & ox_overlap

  collected = touch & ~is_lyre
  reward = POINTS * collected.any(dim=1).to(torch.float32)
  vulnerable = state.respawn_delay <= 0
  respawn_delay = torch.clamp(state.respawn_delay - 1, min=0)
  lyre_hit = (touch & is_lyre).any(dim=1) & vulnerable
  live = live & ~collected
  lives = state.lives - lyre_hit.to(torch.int32)
  respawn_delay = torch.where(lyre_hit, RESPAWN_FRAMES,
                              respawn_delay).to(torch.int32)
  # A hit clears the field (the cartridge resets the wave).
  live = live & ~lyre_hit[:, None]
  score = state.score + reward

  done = lives <= 0
  new_state = AsterixState(px, py, ox, live, is_lyre, score, lives,
                           respawn_delay)
  life_lost = lyre_hit & ~done
  return new_state, reward, done, life_lost


def asterix_render(state: AsterixState) -> torch.Tensor:
  b = state.player_x.shape[0]
  dev = state.player_x.device
  c = _tables(dev)
  # Each lane's object, where live. The lanes' rows do not overlap, so a
  # row shows the columns of its own lane's object: the same pixels as the
  # reference's lane-by-lane selects.
  cols = torch.arange(160, dtype=torch.int32, device=dev)
  x0 = state.obj_x.to(torch.int32)[..., None]
  x1 = (state.obj_x + OBJ_W).to(torch.int32)[..., None]
  in_cols = (cols >= x0) & (cols < x1) & state.obj_live[..., None]
  lyre_cols = in_cols & state.obj_is_lyre[..., None]  # (B, NUM_LANES, 160)
  gold_cols = in_cols & ~state.obj_is_lyre[..., None]
  lyre = lyre_cols[:, c.lane_of_row] & c.row_in_lane  # (B, 210, 160)
  gold = gold_cols[:, c.lane_of_row] & c.row_in_lane
  player = render.rect_mask(state.player_y, state.player_y + PLAYER_H,
                            state.player_x, state.player_x + PLAYER_W, dev)
  return render.compose(b, dev, (82, 126, 45),
                        (c.border, (45, 50, 184)),
                        (gold, COLLECT_COLOR),
                        (lyre, LYRE_COLOR),
                        (player, PLAYER_COLOR))


def asterix_lives(state: AsterixState) -> torch.Tensor:
  return state.lives


GAME = register_game(Game(
    name="asterix",
    num_actions=9,
    init=asterix_init,
    step=asterix_step,
    render=asterix_render,
    lives=asterix_lives,
    init_draws=asterix_init_draws,
    step_draws=asterix_step_draws,
    per_frame_draws=True,
))
