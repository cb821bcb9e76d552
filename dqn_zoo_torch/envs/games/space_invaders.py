"""Space Invaders, batched (port of dqn_zoo_tpu/envs/games/space_invaders.py).

Same constants, update order, float expressions and colours as the
reference: a marching 6 x 6 alien grid scored by row, one shot on screen, 3
bomb slots, 3 lives, a new wave lower and faster. The reference splits a key
carried in the state on every raw frame (a random column and a spawn test
for each bomb slot); here the state carries no key, `init` takes
`SpaceInvadersInitDraws` and `step` takes `SpaceInvadersStepDraws`, the
draws of one raw frame. The game declares `per_frame_draws`, so the vector
env hands each frame of a group and of the noop burn its own.

The march speed and the grid lookups take the reference's compiled
arithmetic (`envs.f32`): XLA divides by a constant as a product with its f32
reciprocal and fuses the speed's products and sums into multiply-adds, so
the floors pick the reference's aliens on the CPU and on the card.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from dqn_zoo_torch.envs import f32, render
from dqn_zoo_torch.envs.api import Game, register_game

ROWS, COLS = 6, 6
ALIEN_W, ALIEN_H = 8, 8
SPACING_X, SPACING_Y = 16, 14
LEFT_WALL, RIGHT_WALL = 8.0, 152.0
START_X, START_Y = 26.0, 52.0
PLAYER_Y = 185
PLAYER_W, PLAYER_H = 8, 8
PLAYER_SPEED = 2.0
SHOT_W, SHOT_SPEED = 2, 6.0
NUM_BOMBS = 3
BOMB_W, BOMB_H, BOMB_SPEED = 2, 6, 2.5
BOMB_PROB = 0.02  # per-slot per-frame spawn probability
LIVES = 3
RESPAWN_FRAMES = 30
ROW_POINTS = (30.0, 25.0, 20.0, 15.0, 10.0, 5.0)  # top row first


class SpaceInvadersState(NamedTuple):
  player_x: torch.Tensor  # (B,) f32, left edge
  aliens: torch.Tensor  # (B, ROWS, COLS) bool
  grid_x: torch.Tensor  # (B,) f32, block left edge
  grid_y: torch.Tensor  # (B,) f32, block top edge
  direction: torch.Tensor  # (B,) f32, ±1 march direction
  shot_x: torch.Tensor  # (B,) f32
  shot_y: torch.Tensor  # (B,) f32
  shot_live: torch.Tensor  # (B,) bool
  bomb_x: torch.Tensor  # (B, NUM_BOMBS) f32
  bomb_y: torch.Tensor  # (B, NUM_BOMBS) f32
  bomb_live: torch.Tensor  # (B, NUM_BOMBS) bool
  lives: torch.Tensor  # (B,) i32
  wave: torch.Tensor  # (B,) i32 — completed waves
  respawn_delay: torch.Tensor  # (B,) i32 — invulnerable frames after a hit


class SpaceInvadersInitDraws(NamedTuple):
  player_x: torch.Tensor  # (B,) f32 in [8, 152 - PLAYER_W)


class SpaceInvadersStepDraws(NamedTuple):
  spawn_col: torch.Tensor  # (B, NUM_BOMBS) int in [0, COLS)
  spawn_u: torch.Tensor  # (B, NUM_BOMBS) U[0, 1): a slot spawns where < 0.02


def space_invaders_init_draws(gen, b, device) -> SpaceInvadersInitDraws:
  u = torch.rand((b,), generator=gen, device=device)
  return SpaceInvadersInitDraws(
      player_x=u * (RIGHT_WALL - PLAYER_W - LEFT_WALL) + LEFT_WALL)


def space_invaders_step_draws(gen, b, device,
                              frames: int) -> SpaceInvadersStepDraws:
  """The bomb draws of `frames` raw frames: (frames, B, NUM_BOMBS) each."""
  shape = (frames, b, NUM_BOMBS)
  return SpaceInvadersStepDraws(
      spawn_col=torch.randint(0, COLS, shape, generator=gen, device=device,
                              dtype=torch.int32),
      spawn_u=torch.rand(shape, generator=gen, device=device))


def space_invaders_init(draws: SpaceInvadersInitDraws) -> SpaceInvadersState:
  b = draws.player_x.shape[0]
  dev = draws.player_x.device
  f = lambda v, *s: torch.full((b,) + s, v, dtype=torch.float32, device=dev)
  i = lambda v: torch.full((b,), v, dtype=torch.int32, device=dev)
  return SpaceInvadersState(
      player_x=draws.player_x.to(torch.float32),
      aliens=torch.ones((b, ROWS, COLS), dtype=torch.bool, device=dev),
      grid_x=f(START_X),
      grid_y=f(START_Y),
      direction=f(1.0),
      shot_x=f(0.0),
      shot_y=f(0.0),
      shot_live=torch.zeros((b,), dtype=torch.bool, device=dev),
      bomb_x=f(0.0, NUM_BOMBS),
      bomb_y=f(0.0, NUM_BOMBS),
      bomb_live=torch.zeros((b, NUM_BOMBS), dtype=torch.bool, device=dev),
      lives=i(LIVES),
      wave=i(0),
      respawn_delay=i(0),
  )


class _Tables(NamedTuple):
  row_points: torch.Tensor  # (ROWS,) f32
  idx_f: torch.Tensor  # (COLS,) f32, 0 .. COLS - 1 (ROWS == COLS)
  row_ids: torch.Tensor  # (1, ROWS, 1) i32
  cell_rows: torch.Tensor  # (1, ROWS, 1) i64
  cell_cols: torch.Tensor  # (1, 1, COLS) i64
  pix_rows: torch.Tensor  # (210,) f32
  pix_cols: torch.Tensor  # (160,) f32
  ground: torch.Tensor  # (210, 160) bool


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> _Tables:
  """The step's and the render's constant tensors on `device`, copied there
  once."""
  return _Tables(
      row_points=torch.tensor(ROW_POINTS, dtype=torch.float32,
                              device=device),
      idx_f=torch.arange(COLS, dtype=torch.float32, device=device),
      row_ids=torch.arange(ROWS, dtype=torch.int32,
                           device=device)[None, :, None],
      cell_rows=torch.arange(ROWS, device=device)[None, :, None],
      cell_cols=torch.arange(COLS, device=device)[None, None, :],
      pix_rows=torch.arange(210, dtype=torch.float32, device=device),
      pix_cols=torch.arange(160, dtype=torch.float32, device=device),
      ground=render.rect_mask(195, 197, 0, 160, device))


def space_invaders_step(state: SpaceInvadersState, action: torch.Tensor,
                        draws: SpaceInvadersStepDraws):
  c = _tables(state.player_x.device)
  right = (action == 2) | (action == 4)
  left = (action == 3) | (action == 5)
  fire = (action == 1) | (action == 4) | (action == 5)
  zero = torch.zeros_like(state.player_x)
  dx = torch.where(right, PLAYER_SPEED,
                   torch.where(left, -PLAYER_SPEED, zero))
  player_x = torch.clamp(state.player_x + dx, LEFT_WALL,
                         RIGHT_WALL - PLAYER_W)

  # Alien march: drift, descend and turn at the walls; faster as the wave
  # thins and across waves: 0.25 + 0.9 (1 - alive share) + 0.1 wave, as
  # XLA compiles it, three multiply-adds.
  aliens0 = state.aliens
  alive = aliens0.flatten(1).sum(dim=1, dtype=torch.float32)
  thinned = f32.fma(-alive, f32.recip(ROWS * COLS), 1.0)
  speed = f32.fma(state.wave.to(torch.float32), 0.1,
                  f32.fma(thinned, 0.9, 0.25))
  gx = state.grid_x + state.direction * speed
  # Only columns that still have aliens bound the block against the walls.
  col_alive = aliens0.any(dim=1)  # (B, COLS)
  lo_col = torch.where(col_alive, c.idx_f, COLS - 1.0).amin(dim=1)
  hi_col = torch.where(col_alive, c.idx_f, 0.0).amax(dim=1)
  block_left = gx + lo_col * SPACING_X
  block_right = gx + hi_col * SPACING_X + ALIEN_W
  at_edge = (block_left < LEFT_WALL) | (block_right > RIGHT_WALL)
  direction = torch.where(at_edge, -state.direction, state.direction)
  gy = state.grid_y + torch.where(at_edge, 8.0, zero)
  gx = torch.where(at_edge, state.grid_x, gx)

  # The player's shot: one on screen at a time.
  do_fire = fire & ~state.shot_live
  shot_x = torch.where(do_fire, player_x + PLAYER_W / 2, state.shot_x)
  shot_y = torch.where(do_fire, float(PLAYER_Y) - 2.0, state.shot_y)
  shot_live = state.shot_live | do_fire
  shot_y = shot_y - torch.where(shot_live, SHOT_SPEED, zero)
  shot_live = shot_live & (shot_y > 34.0)

  # Shot <-> alien: the shot mapped into the (row, col) grid.
  rel_x = shot_x - gx
  rel_y = shot_y - gy
  col = torch.floor(rel_x * f32.recip(SPACING_X)).to(torch.int32)
  row = torch.floor(rel_y * f32.recip(SPACING_Y)).to(torch.int32)
  in_cell_x = (rel_x - col.to(torch.float32) * SPACING_X) < (ALIEN_W + SHOT_W)
  in_cell_y = (rel_y - row.to(torch.float32) * SPACING_Y) < ALIEN_H
  in_grid = ((row >= 0) & (row < ROWS) & (col >= 0) & (col < COLS)
             & in_cell_x & in_cell_y & shot_live)
  rc = torch.clamp(row, 0, ROWS - 1).long()
  cc = torch.clamp(col, 0, COLS - 1).long()
  cell = (c.cell_rows == rc[:, None, None]) & (c.cell_cols == cc[:, None, None])
  hit = in_grid & (aliens0 & cell).flatten(1).any(dim=1)
  aliens = aliens0 & ~(cell & hit[:, None, None])
  shot_live = shot_live & ~hit
  reward = torch.where(hit, c.row_points[rc], zero)

  # Bombs: idle slots spawn from the lowest live alien of a random column.
  spawn_col = draws.spawn_col.long()  # (B, NUM_BOMBS)
  in_col = torch.gather(aliens, 2, spawn_col[:, None, :].expand(
      -1, ROWS, -1))  # (B, ROWS, NUM_BOMBS)
  col_has = in_col.any(dim=1)
  lowest = torch.where(in_col, c.row_ids, -1).amax(dim=1)
  do_spawn = (~state.bomb_live & col_has & (draws.spawn_u < BOMB_PROB))
  bomb_x = torch.where(
      do_spawn,
      gx[:, None] + spawn_col.to(torch.float32) * SPACING_X + ALIEN_W / 2,
      state.bomb_x)
  bomb_y = torch.where(
      do_spawn,
      gy[:, None] + (lowest.to(torch.float32) + 1.0) * SPACING_Y,
      state.bomb_y)
  bomb_live = state.bomb_live | do_spawn
  bomb_y = bomb_y + torch.where(bomb_live, BOMB_SPEED, 0.0)
  bomb_live = bomb_live & (bomb_y < 200.0)

  # Bomb <-> player (skipped while invulnerable after a hit).
  vulnerable = state.respawn_delay <= 0
  respawn_delay = torch.clamp(state.respawn_delay - 1, min=0)
  px = player_x[:, None]
  overlap = (bomb_live
             & (bomb_x + BOMB_W >= px)
             & (bomb_x <= px + PLAYER_W)
             & (bomb_y + BOMB_H >= PLAYER_Y)
             & (bomb_y <= PLAYER_Y + PLAYER_H))
  player_hit = overlap.any(dim=1) & vulnerable
  bomb_live = bomb_live & ~player_hit[:, None]  # a hit clears every bomb
  lives = state.lives - player_hit.to(torch.int32)
  respawn_delay = torch.where(player_hit, RESPAWN_FRAMES,
                              respawn_delay).to(torch.int32)

  # Wave cleared: a new one, lower and faster.
  cleared = ~aliens.flatten(1).any(dim=1)
  aliens = aliens | cleared[:, None, None]
  wave = state.wave + cleared.to(torch.int32)
  gy = torch.where(cleared, torch.clamp(
      START_Y + 8.0 * wave.to(torch.float32), max=90.0), gy)
  gx = torch.where(cleared, START_X, gx)

  # Terminal: the aliens reach the cannon row, or no lives are left.
  row_alive = aliens.any(dim=2)
  low_row = torch.where(row_alive, c.idx_f, 0.0).amax(dim=1)
  invaded = gy + low_row * SPACING_Y + ALIEN_H >= PLAYER_Y
  done = (lives <= 0) | invaded

  new_state = SpaceInvadersState(
      player_x, aliens, gx, gy, direction, shot_x, shot_y, shot_live,
      bomb_x, bomb_y, bomb_live, lives, wave, respawn_delay)
  life_lost = player_hit & ~done
  return new_state, reward, done, life_lost


def space_invaders_render(state: SpaceInvadersState) -> torch.Tensor:
  b = state.player_x.shape[0]
  dev = state.player_x.device
  c = _tables(dev)
  # An alien pixel: its (row, col) cell is alive and it lies inside that
  # cell's ALIEN_W x ALIEN_H box. Rows and columns separate: the same
  # per-pixel arithmetic as the reference's, on (B, 210) and (B, 160).
  rel_y = c.pix_rows - state.grid_y[:, None]
  rel_x = c.pix_cols - state.grid_x[:, None]
  cell_r = torch.floor(rel_y * f32.recip(SPACING_Y)).to(torch.int32)
  cell_c = torch.floor(rel_x * f32.recip(SPACING_X)).to(torch.int32)
  ok_r = ((rel_y - cell_r.to(torch.float32) * SPACING_Y < ALIEN_H)
          & (cell_r >= 0) & (cell_r < ROWS) & (rel_y >= 0))
  ok_c = ((rel_x - cell_c.to(torch.float32) * SPACING_X < ALIEN_W)
          & (cell_c >= 0) & (cell_c < COLS) & (rel_x >= 0))
  by_row = torch.gather(state.aliens, 1, torch.clamp(cell_r, 0, ROWS - 1)
                        .long()[:, :, None].expand(-1, -1, COLS))
  alive = torch.gather(by_row, 2, torch.clamp(cell_c, 0, COLS - 1)
                       .long()[:, None, :].expand(-1, 210, -1))
  alien_mask = alive & ok_r[:, :, None] & ok_c[:, None, :]

  player = render.rect_mask(PLAYER_Y, PLAYER_Y + PLAYER_H, state.player_x,
                            state.player_x + PLAYER_W, dev)
  shot = render.rect_mask(state.shot_y, state.shot_y + 6, state.shot_x,
                          state.shot_x + SHOT_W, dev)
  shot = shot & state.shot_live[:, None, None]
  bombs = torch.zeros((b, 210, 160), dtype=torch.bool, device=dev)
  for i in range(NUM_BOMBS):
    m = render.rect_mask(state.bomb_y[:, i], state.bomb_y[:, i] + BOMB_H,
                         state.bomb_x[:, i], state.bomb_x[:, i] + BOMB_W, dev)
    bombs = bombs | (m & state.bomb_live[:, i, None, None])
  return render.compose(
      b, dev, (0, 0, 0),
      (c.ground, (142, 142, 142)),
      (alien_mask, (134, 134, 29)),
      (bombs, (236, 140, 30)),
      (shot, (236, 236, 236)),
      (player, (50, 132, 50)),
  )


def space_invaders_lives(state: SpaceInvadersState) -> torch.Tensor:
  return state.lives


GAME = register_game(Game(
    name="space_invaders",
    num_actions=6,
    init=space_invaders_init,
    step=space_invaders_step,
    render=space_invaders_render,
    lives=space_invaders_lives,
    init_draws=space_invaders_init_draws,
    step_draws=space_invaders_step_draws,
    per_frame_draws=True,
))
