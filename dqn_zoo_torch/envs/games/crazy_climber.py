"""Crazy Climber, batched (port of dqn_zoo_tpu/envs/games/crazy_climber.py).

Same constants, update order, float expressions and colours as the
reference: a climber on a 7-column window grid, shutters that close on a
cycle and block UP, falling pots that knock the climber down two rows (5
lives), 300 a row gained and 2,000 for topping a building, 9 actions. The
reference splits a key carried in the state at init (the climber's column,
the columns' shutter phases) and on every raw frame (a spawn test, a column
and a bias test for each pot slot); here the state carries no key, `init`
takes `CrazyClimberInitDraws` and `step` takes `CrazyClimberStepDraws`,
the draws of one raw frame. The game declares `per_frame_draws`, so the
vector env hands each frame of a group and of the noop burn its own.

The pots' speed ramp takes the reference's compiled arithmetic
(`envs.f32`): one multiply-add.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from dqn_zoo_torch.envs import f32, render
from dqn_zoo_torch.envs.api import Game, register_game

COLS = 7
ROWS = 24  # building height in window rows
WIN_W, WIN_H = 14, 10  # window cell size in world px
BLDG_LEFT = 26.0
COL_PITCH = 16.0  # horizontal window pitch
ROW_PITCH = 14.0
CLIMBER_W, CLIMBER_H = 10, 12
CLIMBER_Y = 150.0  # fixed screen row; the building scrolls
NUM_POTS = 3
POT_W, POT_H = 4, 4
POT_SPEED = 2.6
POT_PROB = 0.02
BIAS_PROB = 0.5  # a pot falls down the climber's column with this chance
LIVES = 5
HIT_PAUSE = 40
MOVE_COOLDOWN = 6  # frames between grid moves (climbing rhythm)
ROW_POINTS = 300.0
TOP_BONUS = 2000.0
SHUT_PERIOD = 180  # window shutter cycle in frames
ROW_PHASE = 37  # shutter phase step from one window row to the next
VISIBLE_ROWS = 10  # window rows drawn, the climber's fifth from the top


class CrazyClimberState(NamedTuple):
  col: torch.Tensor  # (B,) i32 grid column
  row: torch.Tensor  # (B,) i32 rows climbed from the bottom (0 = street)
  move_cd: torch.Tensor  # (B,) i32
  shut_phase: torch.Tensor  # (B, COLS) i32 per-column shutter phases
  pot_col: torch.Tensor  # (B, NUM_POTS) i32
  pot_y: torch.Tensor  # (B, NUM_POTS) f32 world y
  pot_live: torch.Tensor  # (B, NUM_POTS) bool
  lives: torch.Tensor  # (B,) i32
  building: torch.Tensor  # (B,) i32 completed buildings
  frame: torch.Tensor  # (B,) i32
  hit_pause: torch.Tensor  # (B,) i32


class CrazyClimberInitDraws(NamedTuple):
  col: torch.Tensor  # (B,) int in [0, COLS)
  shut_phase: torch.Tensor  # (B, COLS) int in [0, SHUT_PERIOD)


class CrazyClimberStepDraws(NamedTuple):
  spawn_u: torch.Tensor  # (B, NUM_POTS) U[0, 1): a slot spawns where < 0.02
  col: torch.Tensor  # (B, NUM_POTS) int in [0, COLS), an unbiased column
  bias_u: torch.Tensor  # (B, NUM_POTS) U[0, 1): the climber's column if < .5


def crazy_climber_init_draws(gen, b, device) -> CrazyClimberInitDraws:
  r = lambda hi, *s: torch.randint(0, hi, (b,) + s, generator=gen,
                                   device=device, dtype=torch.int32)
  return CrazyClimberInitDraws(col=r(COLS), shut_phase=r(SHUT_PERIOD, COLS))


def crazy_climber_step_draws(gen, b, device,
                             frames: int) -> CrazyClimberStepDraws:
  """The pot draws of `frames` raw frames: (frames, B, NUM_POTS) each."""
  shape = (frames, b, NUM_POTS)
  return CrazyClimberStepDraws(
      spawn_u=torch.rand(shape, generator=gen, device=device),
      col=torch.randint(0, COLS, shape, generator=gen, device=device,
                        dtype=torch.int32),
      bias_u=torch.rand(shape, generator=gen, device=device))


def crazy_climber_init(draws: CrazyClimberInitDraws) -> CrazyClimberState:
  b = draws.col.shape[0]
  dev = draws.col.device
  i = lambda v, *s: torch.full((b,) + s, v, dtype=torch.int32, device=dev)
  return CrazyClimberState(
      col=draws.col.to(torch.int32),
      row=i(0),
      move_cd=i(0),
      shut_phase=draws.shut_phase.to(torch.int32),
      pot_col=i(0, NUM_POTS),
      pot_y=torch.zeros((b, NUM_POTS), dtype=torch.float32, device=dev),
      pot_live=torch.zeros((b, NUM_POTS), dtype=torch.bool, device=dev),
      lives=i(LIVES),
      building=i(0),
      frame=i(0),
      hit_pause=i(0),
  )


def _shutter_closed(frame, phase, row):
  """A window is closed for the last third of its cycle; its phase moves
  with the frame clock and differs by column (`phase`, the column's offset)
  and by row. jnp.mod of int32 is a floor remainder, as torch's is."""
  at = torch.remainder(frame + phase + row * ROW_PHASE, SHUT_PERIOD)
  return at >= (SHUT_PERIOD * 2) // 3


class _Tables(NamedTuple):
  building: torch.Tensor  # (210, 160) bool
  cell: torch.Tensor  # (210 * 160,) i64: 1 + window (vis * COLS + col), or 0
  vis: torch.Tensor  # (VISIBLE_ROWS, 1) i32, 0 .. 9


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> _Tables:
  """The render's constant tensors on `device`, copied there once. The
  windows' boxes are static and do not overlap: each pixel holds the index
  of the window it lies in plus one, or 0."""
  cell = torch.zeros((210, 160), dtype=torch.int64, device=device)
  for vis in range(VISIBLE_ROWS):
    y0 = CLIMBER_Y - (4 - vis) * ROW_PITCH - WIN_H
    for c in range(COLS):
      x0 = BLDG_LEFT + c * COL_PITCH
      m = render.rect_mask(int(y0), int(y0 + WIN_H), int(x0), int(x0 + WIN_W),
                           device)
      cell.masked_fill_(m, 1 + vis * COLS + c)
  right = BLDG_LEFT + (COLS - 1) * COL_PITCH + WIN_W + 8
  return _Tables(
      building=render.rect_mask(20, 200, int(BLDG_LEFT - 8), int(right),
                                device),
      cell=cell.flatten(),
      vis=torch.arange(VISIBLE_ROWS, dtype=torch.int32,
                       device=device)[:, None])


def crazy_climber_step(state: CrazyClimberState, action: torch.Tensor,
                       draws: CrazyClimberStepDraws):
  up = (action == 1) | (action == 5) | (action == 6)
  right = (action == 2) | (action == 5) | (action == 7)
  left = (action == 3) | (action == 6) | (action == 8)
  down = (action == 4) | (action == 7) | (action == 8)

  can_move = state.move_cd <= 0
  move_cd = torch.clamp(state.move_cd - 1, min=0)
  dc = right.to(torch.int32) - left.to(torch.int32)
  col = torch.clamp(state.col + torch.where(can_move, dc, 0), 0,
                    COLS - 1).to(torch.int32)
  # UP is blocked while the window above is shuttered.
  phase = torch.gather(state.shut_phase, 1, col.long()[:, None])[:, 0]
  closed_above = _shutter_closed(state.frame, phase, state.row + 1)
  dr = (up & ~closed_above).to(torch.int32) - down.to(torch.int32)
  dr = torch.where(can_move, dr, 0)
  row = torch.clamp(state.row + dr, 0, ROWS).to(torch.int32)
  moved = (col != state.col) | (row != state.row)
  move_cd = torch.where(moved, MOVE_COOLDOWN, move_cd)
  zero = torch.zeros((col.shape[0],), dtype=torch.float32, device=col.device)
  reward = torch.where(row > state.row, ROW_POINTS, zero)

  # Pots fall down random columns, half of them the climber's.
  spawn = ~state.pot_live & (draws.spawn_u < POT_PROB)
  new_col = torch.where(draws.bias_u < BIAS_PROB, col[:, None],
                        draws.col.to(torch.int32))
  pot_col = torch.where(spawn, new_col, state.pot_col)
  pot_y = torch.where(spawn, 0.0, state.pot_y)
  pot_live = state.pot_live | spawn
  speed = f32.fma(state.building.to(torch.float32), 0.4, POT_SPEED)
  pot_y = pot_y + torch.where(pot_live, speed[:, None], 0.0)
  pot_live = pot_live & (pot_y < 210.0)

  # Pots in the climber's column that reach his screen row knock him down
  # (not during the pause after a knock).
  vulnerable = state.hit_pause <= 0
  hit_pause = torch.clamp(state.hit_pause - 1, min=0)
  pot_hits = (pot_live & (pot_col == col[:, None])
              & (pot_y + POT_H >= CLIMBER_Y)
              & (pot_y <= CLIMBER_Y + CLIMBER_H))
  knocked = pot_hits.any(dim=1) & vulnerable
  pot_live = pot_live & ~pot_hits
  lives = state.lives - knocked.to(torch.int32)
  hit_pause = torch.where(knocked, HIT_PAUSE, hit_pause)
  # A knockdown also costs height: a fall of two rows.
  row = torch.where(knocked, torch.clamp(row - 2, min=0), row)

  # Topped the building: a bonus, and the next one is faster.
  topped = row >= ROWS
  reward = reward + torch.where(topped, TOP_BONUS, zero)
  building = state.building + topped.to(torch.int32)
  row = torch.where(topped, 0, row)

  frame = state.frame + 1
  done = lives <= 0
  new_state = CrazyClimberState(col, row, move_cd, state.shut_phase,
                                pot_col, pot_y, pot_live, lives, building,
                                frame, hit_pause)
  life_lost = knocked & ~done
  return new_state, reward, done, life_lost


def crazy_climber_render(state: CrazyClimberState) -> torch.Tensor:
  b = state.col.shape[0]
  dev = state.col.device
  c = _tables(dev)
  rect = lambda *box: render.rect_mask(*box, dev)
  # Windows: 10 visible rows scrolled so the climber's row sits at y=150;
  # (B, 10, 7) open and closed shutters, painted through the pixel table.
  wrow = state.row[:, None, None] + 4 - c.vis[None]  # (B, 10, 1)
  valid = (wrow >= 0) & (wrow <= ROWS)
  closed = _shutter_closed(state.frame[:, None, None],
                           state.shut_phase[:, None, :], wrow) & valid
  open_ = valid & ~closed
  pad = torch.zeros((b, 1), dtype=torch.bool, device=dev)
  paint = lambda m: torch.cat([pad, m.flatten(1)], dim=1)[:, c.cell].reshape(
      b, 210, 160)
  pots = torch.zeros((b, 210, 160), dtype=torch.bool, device=dev)
  for i in range(NUM_POTS):
    x0 = BLDG_LEFT + state.pot_col[:, i].to(torch.float32) * COL_PITCH + 5.0
    y = state.pot_y[:, i]
    pots = pots | (rect(y, y + POT_H, x0, x0 + POT_W)
                   & state.pot_live[:, i, None, None])
  cx = BLDG_LEFT + state.col.to(torch.float32) * COL_PITCH + 2.0
  climber = rect(int(CLIMBER_Y), int(CLIMBER_Y) + CLIMBER_H, cx,
                 cx + CLIMBER_W)
  return render.compose(
      b, dev, (40, 44, 60),
      (c.building, (120, 116, 100)),
      (paint(open_), (210, 220, 235)),
      (paint(closed), (70, 66, 56)),
      (pots, (220, 90, 60)),
      (climber, (230, 60, 120)),
  )


def crazy_climber_lives(state: CrazyClimberState) -> torch.Tensor:
  return state.lives


GAME = register_game(Game(
    name="crazy_climber",
    num_actions=9,
    init=crazy_climber_init,
    step=crazy_climber_step,
    render=crazy_climber_render,
    lives=crazy_climber_lives,
    init_draws=crazy_climber_init_draws,
    step_draws=crazy_climber_step_draws,
    per_frame_draws=True,
))
