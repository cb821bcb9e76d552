"""Q*bert, batched (port of dqn_zoo_tpu/envs/games/qbert.py).

Same constants, update order, cube geometry and colours as the reference:
the player hops diagonally over a 28-cube pyramid, +25 for each cube newly
coloured, +1,000 when all 28 are and the board starts fresh, a red ball
bounces down from the apex and Coily chases the player; a hop off the
pyramid or a touch of either costs one of 4 lives, 20,000-frame episodes,
6 actions. The reference's init draws nothing; its step splits a key
carried in the state on every raw frame, draws the ball's spawn side from
one part and its hop side from that part folded with 1, and Coily's four
tie-breaks from another. Here the state carries no key, `init` takes
`QbertInitDraws` (the batch and the device only) and `step` takes
`QbertStepDraws`, the draws of one raw frame. The game declares
`per_frame_draws`, so the vector env hands each frame of a group and of
the noop burn its own.

Every position is a cube index, every timer an integer and every
coordinate an integer held in f32, so no rounding can differ from the
reference's.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from dqn_zoo_torch.envs import render
from dqn_zoo_torch.envs.api import Game, register_game

N = 7  # pyramid rows; row r has r+1 cubes, 28 in all
HOP_PERIOD = 16  # raw frames a player hop
COILY_PERIOD = 20  # raw frames a Coily hop
BALL_PERIOD = 18
BALL_SPAWN_EVERY = 280  # frames between red-ball spawns
COILY_HATCH_FRAMES = 140  # Coily appears after this many frames
CUBE_POINTS = 25.0
ROUND_BONUS = 1000.0
LIVES = 4
EPISODE_FRAMES = 20000
DEATH_FREEZE = 30  # frames frozen after a death

CUBE_W, CUBE_H = 22, 11
ROW_DY = 24

# The joystick's hops: UP (r-1, c), RIGHT (r+1, c+1), LEFT (r-1, c-1),
# DOWN (r+1, c); NOOP and FIRE stay.
_HOP_DR = (0, 0, -1, 1, -1, 1)
_HOP_DC = (0, 0, 0, 1, -1, 0)
# Coily's four diagonal candidates.
_COILY_DR = (-1, -1, 1, 1)
_COILY_DC = (-1, 0, 0, 1)


def _cube_x(r, c):
  return 80.0 + (2.0 * c - r) * (CUBE_W / 2.0) - CUBE_W / 2.0


def _cube_y(r):
  return 38.0 + r * ROW_DY


# The cube geometry as the reference holds it, f32 on the host.
_CUBE_XS = np.asarray([[_cube_x(r, c) for c in range(N)] for r in range(N)],
                      np.float32)
_CUBE_YS = np.asarray([_cube_y(r) for r in range(N)], np.float32)


class QbertState(NamedTuple):
  pr: torch.Tensor  # (B,) i32 player cube row
  pc: torch.Tensor  # (B,) i32 player cube column (0..pr)
  colored: torch.Tensor  # (B, N, N) bool, lower triangle meaningful
  cr: torch.Tensor  # (B,) i32 Coily row (-1: not hatched)
  cc: torch.Tensor  # (B,) i32
  br: torch.Tensor  # (B,) i32 red ball row (-1: inactive)
  bc: torch.Tensor  # (B,) i32
  lives: torch.Tensor  # (B,) i32
  freeze: torch.Tensor  # (B,) i32 death-freeze frames left
  frame: torch.Tensor  # (B,) i32


class QbertInitDraws(NamedTuple):
  batch: torch.Tensor  # (B,) i32 zeros: no draw, the batch and the device


class QbertStepDraws(NamedTuple):
  ball_side: torch.Tensor  # (B,) bool, a spawning ball's column
  ball_hop: torch.Tensor  # (B,) bool, a hopping ball's column step
  coily_u: torch.Tensor  # (B, 4) f32 in [0, 0.3), the chase's tie-breaks


def qbert_init_draws(gen, b, device) -> QbertInitDraws:
  del gen  # every episode starts alike
  return QbertInitDraws(
      batch=torch.zeros((b,), dtype=torch.int32, device=device))


def qbert_step_draws(gen, b, device, frames: int) -> QbertStepDraws:
  """The ball's coins and Coily's tie-breaks of `frames` raw frames:
  (frames, B) and (frames, B, 4)."""
  coins = torch.rand((2, frames, b), generator=gen, device=device) < 0.5
  return QbertStepDraws(
      ball_side=coins[0], ball_hop=coins[1],
      coily_u=torch.rand((frames, b, 4), generator=gen, device=device)
      * 0.3)


def qbert_init(draws: QbertInitDraws) -> QbertState:
  b = draws.batch.shape[0]
  dev = draws.batch.device
  i = lambda v: torch.full((b,), v, dtype=torch.int32, device=dev)
  return QbertState(
      pr=i(0), pc=i(0),
      colored=torch.zeros((b, N, N), dtype=torch.bool, device=dev),
      cr=i(-1), cc=i(0), br=i(-1), bc=i(0), lives=i(LIVES), freeze=i(0),
      frame=i(0))


class _Tables(NamedTuple):
  hop_dr: torch.Tensor  # (6,) i32 by action
  hop_dc: torch.Tensor  # (6,) i32
  coily_dr: torch.Tensor  # (1, 4) i32
  coily_dc: torch.Tensor  # (1, 4) i32
  outside: torch.Tensor  # (N * N,) bool: the cells off the pyramid
  cube_xs: torch.Tensor  # (N * N,) f32
  cube_ys: torch.Tensor  # (N,) f32
  top_cell: torch.Tensor  # (210 * 160,) i64: the cube whose top covers
                          # the pixel (the tops do not overlap), or N * N
  tops: torch.Tensor  # (210, 160) bool, every cube's top
  faces: torch.Tensor  # (210, 160) bool, every cube's face


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> _Tables:
  """The step's and the render's constant tensors on `device`, copied there
  once."""
  i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=device)
  top_cell = np.full((210, 160), N * N, np.int64)
  faces = np.zeros((210, 160), bool)
  for r in range(N):
    y = int(_CUBE_YS[r])
    for c in range(r + 1):
      x = int(_CUBE_XS[r, c])
      top_cell[y:y + CUBE_H, x:x + CUBE_W] = r * N + c
      faces[y + CUBE_H:y + CUBE_H + 8, x + 3:x + CUBE_W - 3] = True
  top_cell = torch.from_numpy(top_cell).to(device)
  return _Tables(
      hop_dr=i32(_HOP_DR), hop_dc=i32(_HOP_DC),
      coily_dr=i32(_COILY_DR)[None], coily_dc=i32(_COILY_DC)[None],
      outside=~torch.ones((N, N), dtype=torch.bool,
                          device=device).tril().reshape(-1),
      cube_xs=torch.from_numpy(_CUBE_XS.reshape(-1)).to(device),
      cube_ys=torch.from_numpy(_CUBE_YS).to(device),
      top_cell=top_cell.reshape(-1), tops=top_cell < N * N,
      faces=torch.from_numpy(faces).to(device))


def _valid(r, c):
  return (r >= 0) & (r < N) & (c >= 0) & (c <= r)


def _cell(r, c):
  """(B,) rows and columns -> their flat cell, clipped onto the board as
  the reference clips its index."""
  return (torch.clamp(r, 0, N - 1) * N + torch.clamp(c, 0, N - 1)).to(
      torch.int64)


def _colour_apex(colored, where):
  """(B, N * N) board with the apex coloured where `where` holds."""
  return torch.cat([(colored[:, 0] | where)[:, None], colored[:, 1:]], 1)


def qbert_step(state: QbertState, action: torch.Tensor,
               draws: QbertStepDraws):
  t = _tables(state.pr.device)
  b = state.pr.shape[0]
  frame = state.frame + 1
  frozen = state.freeze > 0
  freeze = torch.clamp(state.freeze - 1, min=0)
  colored = state.colored.reshape(b, N * N)
  zero = torch.zeros((b,), dtype=torch.float32, device=state.pr.device)
  points = lambda hit, v: torch.where(hit, v, zero)

  # The landing at spawn colours the apex on the episode's first frame.
  first = frame == 1
  reward = points(first & ~colored[:, 0], CUBE_POINTS)
  colored = _colour_apex(colored, first)

  # The player's hop, every HOP_PERIOD frames.
  dr = t.hop_dr[action]
  dc = t.hop_dc[action]
  moving = (dr != 0) & (frame % HOP_PERIOD == 0) & ~frozen
  tr = state.pr + dr
  tc = state.pc + dc
  on_board = _valid(tr, tc)
  fell = moving & ~on_board
  hop = moving & on_board
  pr = torch.where(hop, tr, state.pr)
  pc = torch.where(hop, tc, state.pc)

  cell = _cell(pr, pc)[:, None]
  was = colored.gather(1, cell)[:, 0]
  colored = colored.scatter(1, cell, (was | hop)[:, None])
  reward = reward + points(hop & ~was, CUBE_POINTS)

  # Round complete: all 28 cubes coloured -> the bonus and a fresh board.
  complete = (colored | t.outside).all(dim=1)
  reward = reward + points(complete, ROUND_BONUS)
  colored = colored & ~complete[:, None]

  # The red ball spawns next to the apex and bounces down.
  spawn_ball = ((state.br < 0) & (frame % BALL_SPAWN_EVERY == 0)
                & ~frozen)
  br = torch.where(spawn_ball, 1, state.br)
  bc = torch.where(spawn_ball, draws.ball_side.to(torch.int32), state.bc)
  ball_hops = (br >= 0) & (frame % BALL_PERIOD == 0) & ~frozen & ~spawn_ball
  br = torch.where(ball_hops, br + 1, br)
  bc = torch.where(ball_hops, bc + draws.ball_hop.to(torch.int32), bc)
  br = torch.where(br >= N, -1, br)  # rolled off the bottom

  # Coily hatches, then hops greedily toward the player: the valid one of
  # four diagonal cubes nearest to it, the tie-breaks added.
  hatch = (state.cr < 0) & (frame > COILY_HATCH_FRAMES) & ~frozen
  cr = torch.where(hatch, 0, state.cr)
  cc = torch.where(hatch, 0, state.cc)
  coily_hops = (cr >= 0) & (frame % COILY_PERIOD == 0) & ~frozen & ~hatch
  cand_r = cr[:, None] + t.coily_dr
  cand_c = cc[:, None] + t.coily_dc
  dist = (torch.abs(cand_r - pr[:, None])
          + torch.abs(cand_c - pc[:, None])).to(torch.float32)
  dist = dist + draws.coily_u.to(torch.float32)
  dist = torch.where(_valid(cand_r, cand_c), dist, 1e9)
  pick = torch.argmin(dist, dim=1, keepdim=True)  # ties: the first
  cr = torch.where(coily_hops, cand_r.gather(1, pick)[:, 0], cr)
  cc = torch.where(coily_hops, cand_c.gather(1, pick)[:, 0], cc)

  # Deaths: a fall, Coily or the ball.
  caught = (cr == pr) & (cc == pc) & (cr >= 0) & ~frozen
  balled = (br == pr) & (bc == pc) & (br >= 0) & ~frozen
  died = fell | caught | balled
  lives = state.lives - died.to(torch.int32)
  done = (lives <= 0) | (frame >= EPISODE_FRAMES)
  # The player back to the apex, the chasers gone, the colours kept; the
  # respawn landing scores an uncoloured apex.
  pr = torch.where(died, 0, pr)
  pc = torch.where(died, 0, pc)
  cr = torch.where(died, -1, cr)
  br = torch.where(died, -1, br)
  freeze = torch.where(died, DEATH_FREEZE, freeze)
  respawn = died & ~done
  reward = reward + points(respawn & ~colored[:, 0], CUBE_POINTS)
  colored = _colour_apex(colored, respawn)

  i32 = lambda x: x.to(torch.int32)
  new_state = QbertState(i32(pr), i32(pc), colored.reshape(b, N, N),
                         i32(cr), i32(cc), i32(br), i32(bc), lives,
                         i32(freeze), frame)
  return new_state, reward, done, died & ~done


def _blob(t, r, c, w, h, dy, dev):
  """The box of a figure on cube (r, c): the reference sums the cube
  table's entries where both indices match, 0 where none does."""
  inside = (r >= 0) & (r < N) & (c >= 0) & (c < N)
  x = torch.where(inside, t.cube_xs[_cell(r, c)], 0.0) + (CUBE_W / 2
                                                           - w / 2)
  y = torch.where((r >= 0) & (r < N),
                  t.cube_ys[torch.clamp(r, 0, N - 1).to(torch.int64)],
                  0.0) + dy
  return render.rect_mask(y, y + h, x, x + w, dev)


def qbert_render(state: QbertState) -> torch.Tensor:
  b = state.pr.shape[0]
  dev = state.pr.device
  t = _tables(dev)
  # Each pixel of a cube top takes its cube's colour.
  padded = torch.cat([state.colored.reshape(b, N * N),
                      torch.zeros((b, 1), dtype=torch.bool, device=dev)], 1)
  lit = padded[:, t.top_cell].reshape(b, 210, 160)
  player = _blob(t, state.pr, state.pc, 8, 10, -10.0, dev)
  coily = _blob(t, torch.clamp(state.cr, min=0), state.cc, 8, 12, -12.0,
                dev) & (state.cr >= 0)[:, None, None]
  ball = _blob(t, torch.clamp(state.br, min=0), state.bc, 6, 6, -6.0,
               dev) & (state.br >= 0)[:, None, None]
  lives_bar = render.rect_mask(200, 206, 8, 8 + 10 * state.lives, dev)
  return render.compose(
      b, dev, (20, 20, 60),
      (t.tops, (66, 110, 210)),
      (lit, (210, 182, 66)),
      (t.faces, (120, 80, 140)),
      (ball, (200, 60, 60)),
      (coily, (170, 80, 200)),
      (player, (230, 120, 40)),
      (lives_bar, (230, 120, 40)),
  )


def qbert_lives(state: QbertState) -> torch.Tensor:
  return state.lives


GAME = register_game(Game(
    name="qbert",
    num_actions=6,
    init=qbert_init,
    step=qbert_step,
    render=qbert_render,
    lives=qbert_lives,
    init_draws=qbert_init_draws,
    step_draws=qbert_step_draws,
    per_frame_draws=True,
))
