"""Gopher, batched (port of dqn_zoo_tpu/envs/games/gopher.py).

Same constants, update order, float expressions and colours as the
reference: a gopher digs along a 16-cell ground line toward the nearest of
three carrots, the farmer's shovel fills the hole under him (+20) or bonks
the gopher when it has popped up (+80), an eaten carrot is gone and the
episode ends with the third or after 20,000 frames (no lives), 8 actions.
The reference's init draws nothing; its step splits a key carried in the
state on every raw frame and reads one coin from it, for both of the edges
the gopher may restart from (after a bonk, after a meal). Here the state
carries no key, `init` takes `GopherInitDraws` (the batch and the device
only) and `step` takes `GopherStepDraws`, the coin of one raw frame. The
game declares `per_frame_draws`, so the vector env hands each frame of a
group and of the noop burn its own.

The farmer's cell takes the reference's compiled arithmetic (`envs.f32`):
XLA multiplies by the f32 reciprocal of the cell width, 0.1f, where the
source divides by 10, and the port writes that product.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from dqn_zoo_torch.envs import f32, render
from dqn_zoo_torch.envs.api import Game, register_game
from dqn_zoo_torch.envs.games import isin

CELLS = 16
CELL_W = 10.0
X0 = 0.0
GROUND_Y = 150.0
FARMER_Y = 120.0
FARMER_SPEED = 2.2
DIG_EVERY = 26  # frames per gopher dig tick
HOLE_DEPTH = 3  # digs to open a hole fully
FILL_POINTS = 20.0
BONK_POINTS = 80.0
POP_EVERY = 160  # the gopher surfaces periodically
POP_FRAMES = 40
CARROT_CELLS = (3, 8, 13)
EPISODE_FRAMES = 20000

FIRE_ACTIONS = (1, 5, 6, 7)
LEFT_ACTIONS = (4, 7)
RIGHT_ACTIONS = (3, 6)


class GopherState(NamedTuple):
  fx: torch.Tensor  # (B,) f32 farmer centre x
  holes: torch.Tensor  # (B, CELLS) i32 dig depth, >= HOLE_DEPTH is open
  gcell: torch.Tensor  # (B,) i32 gopher cell
  popped: torch.Tensor  # (B,) i32 frames of pop-up left (0: underground)
  carrots: torch.Tensor  # (B, 3) bool
  frame: torch.Tensor  # (B,) i32


class GopherInitDraws(NamedTuple):
  batch: torch.Tensor  # (B,) i32 zeros: no draw, the batch and the device


class GopherStepDraws(NamedTuple):
  left_edge: torch.Tensor  # (B,) bool: a restart takes cell 0, else 15


def gopher_init_draws(gen, b, device) -> GopherInitDraws:
  del gen  # every episode starts alike
  return GopherInitDraws(
      batch=torch.zeros((b,), dtype=torch.int32, device=device))


def gopher_step_draws(gen, b, device, frames: int) -> GopherStepDraws:
  """The restart coins of `frames` raw frames: (frames, B)."""
  return GopherStepDraws(left_edge=torch.rand(
      (frames, b), generator=gen, device=device) < 0.5)


def gopher_init(draws: GopherInitDraws) -> GopherState:
  b = draws.batch.shape[0]
  dev = draws.batch.device
  i = lambda *s: torch.zeros((b,) + s, dtype=torch.int32, device=dev)
  return GopherState(
      fx=torch.full((b,), 80.0, dtype=torch.float32, device=dev),
      holes=i(CELLS),
      gcell=i(),
      popped=i(),
      carrots=torch.ones((b, 3), dtype=torch.bool, device=dev),
      frame=i(),
  )


class _Tables(NamedTuple):
  carrot_cells: torch.Tensor  # (1, 3) i32
  scenery: tuple  # the ground's (mask, rgb) layer
  hole_x: tuple  # each cell's centre x, Python floats
  col_hole: torch.Tensor  # (160,) i64: the cell whose hole spans the
                          # column (the spans do not overlap), or CELLS


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> _Tables:
  """The step's and the render's constant tensors on `device`, copied there
  once."""
  hole_x = tuple(X0 + (c + 0.5) * CELL_W for c in range(CELLS))
  col_hole = torch.full((160,), CELLS, dtype=torch.int64)
  for c, x in enumerate(hole_x):  # a hole spans [x - 4, x + 4)
    col_hole[int(x - 4):int(x + 4)] = c
  return _Tables(
      carrot_cells=torch.tensor(CARROT_CELLS, dtype=torch.int32,
                                device=device)[None],
      scenery=((render.rect_mask(int(GROUND_Y), 210, 0, 160, device),
                (150, 110, 60)),),
      hole_x=hole_x, col_hole=col_hole.to(device))


def _restart_cell(left_edge):
  return torch.where(left_edge, 0, CELLS - 1).to(torch.int32)


def gopher_step(state: GopherState, action: torch.Tensor,
                draws: GopherStepDraws):
  c = _tables(state.fx.device)
  rows = torch.arange(state.fx.shape[0], device=state.fx.device)
  frame = state.frame + 1
  fire = isin(action, FIRE_ACTIONS)
  left = isin(action, LEFT_ACTIONS)
  right = isin(action, RIGHT_ACTIONS)
  zero = torch.zeros_like(state.fx)
  fx = torch.clamp(state.fx + torch.where(
      left, -FARMER_SPEED, torch.where(right, FARMER_SPEED, zero)),
      CELL_W / 2, CELLS * CELL_W - CELL_W / 2)
  fcell = torch.clamp((fx * f32.recip(CELL_W)).to(torch.int32), 0,
                      CELLS - 1).long()

  # The shovel fills the farmer's cell, or bonks a popped gopher there.
  popped = state.popped > 0
  bonk = fire & popped & (state.gcell == fcell)
  reward = torch.where(bonk, BONK_POINTS, zero)
  hole_here = state.holes[rows, fcell]
  fill = fire & ~bonk & (hole_here > 0)
  reward = reward + torch.where(fill, FILL_POINTS, zero)
  holes = state.holes.clone()
  holes[rows, fcell] = torch.where(fill, 0, hole_here)

  # A bonked gopher restarts from an edge, underground.
  restart = _restart_cell(draws.left_edge)
  gcell = torch.where(bonk, restart, state.gcell)
  pop_timer = torch.where(bonk, 0, state.popped)

  # The gopher digs toward the nearest carrot left (the first of ties).
  dist = torch.abs(c.carrot_cells - gcell[:, None]) \
      + torch.where(state.carrots, 0, 999)
  target = c.carrot_cells[0, torch.argmin(dist, dim=1)]
  tick = (frame % DIG_EVERY == 0) & ~bonk
  step_dir = torch.sign(target - gcell)
  at_target = step_dir == 0
  gcell = torch.clamp(torch.where(tick & ~at_target, gcell + step_dir,
                                  gcell), 0, CELLS - 1)
  g = gcell.long()
  depth = holes[rows, g]
  holes[rows, g] = torch.where(
      tick, torch.clamp(depth + 1, max=HOLE_DEPTH), depth)

  # A carrot is eaten where the gopher sits at it with a fully open hole.
  eaten = ((c.carrot_cells == gcell[:, None])
           & (holes[rows, g] >= HOLE_DEPTH)[:, None] & state.carrots
           & (tick & at_target)[:, None])
  carrots = state.carrots & ~eaten
  # After a meal it heads for the next carrot from a random edge.
  gcell = torch.where(eaten.any(dim=1), restart, gcell)

  # The pop-up schedule.
  pop_now = (frame % POP_EVERY == 0) & ~bonk
  pop_timer = torch.where(pop_now, POP_FRAMES,
                          torch.clamp(pop_timer - 1, min=0))

  done = ~carrots.any(dim=1) | (frame >= EPISODE_FRAMES)
  new_state = GopherState(fx, holes, gcell, pop_timer, carrots, frame)
  return new_state, reward, done, torch.zeros_like(done)


def gopher_render(state: GopherState) -> torch.Tensor:
  b = state.fx.shape[0]
  dev = state.fx.device
  c = _tables(dev)
  rect = lambda *box: render.rect_mask(*box, dev)
  # A hole is GROUND_Y + 6 depth deep in its columns; one column map for
  # all 16 (a 17th, closed entry for the columns between holes).
  none = torch.zeros((b, 1), dtype=state.holes.dtype, device=dev)
  dug = torch.cat([state.holes, none], dim=1)[:, c.col_hole]  # (B, 160)
  depth = torch.clamp(dug, 0, HOLE_DEPTH).to(torch.float32)
  bottom = (GROUND_Y + 6.0 * depth).to(torch.int32)
  rows = torch.arange(210, dtype=torch.int32, device=dev)[:, None]
  holes = ((rows >= int(GROUND_Y)) & (rows < bottom[:, None, :])
           & (dug > 0)[:, None, :])
  carrots = torch.zeros((b, 210, 160), dtype=torch.bool, device=dev)
  for i, cell in enumerate(CARROT_CELLS):
    x = c.hole_x[cell]
    carrots = carrots | (rect(int(GROUND_Y - 14), int(GROUND_Y),
                              int(x - 3), int(x + 3))
                         & state.carrots[:, i, None, None])
  gx = (state.gcell.to(torch.float32) + 0.5) * CELL_W
  up = state.popped > 0
  gopher = rect(torch.where(up, GROUND_Y - 12.0, GROUND_Y + 20.0),
                torch.where(up, GROUND_Y, GROUND_Y + 30.0), gx - 5, gx + 5)
  farmer = rect(int(FARMER_Y), int(GROUND_Y), state.fx - 5, state.fx + 5)
  return render.compose(
      b, dev, (110, 160, 210),  # sky
      *c.scenery,
      (holes, (70, 45, 25)),
      (carrots, (230, 130, 40)),
      (gopher, (120, 90, 140)),
      (farmer, (240, 240, 240)),
  )


def gopher_lives(state: GopherState) -> torch.Tensor:
  return torch.ones_like(state.frame)


GAME = register_game(Game(
    name="gopher",
    num_actions=8,
    init=gopher_init,
    step=gopher_step,
    render=gopher_render,
    lives=gopher_lives,
    init_draws=gopher_init_draws,
    step_draws=gopher_step_draws,
    per_frame_draws=True,
))
