"""Ms. Pac-Man, batched (port of dqn_zoo_tpu/envs/games/ms_pacman.py).

Same maze, constants, update order, float expressions and colours as the
reference: the player eats the pellets of a 21 x 19 cell maze (+10, +50
for a power pellet), four ghosts chase her and flee while frightened, a
frightened ghost eaten pays 200, 400, 800, ... within one power window, a
caught player loses a life (3 lives), a cleared maze refills, 20,000-frame
episodes, 9 actions. The player moves a cell every 2 raw frames, the ghosts
on the other phase (every 3 frames while frightened). The reference's init
draws nothing; its step splits a key carried in the state on every raw
frame and draws each ghost's four direction scores (used as noise and, for
a random pick, as the scores themselves) and its random-pick test. Here the
state carries no key, `init` takes `MsPacmanInitDraws` (the batch and the
device only) and `step` takes `MsPacmanStepDraws`, the draws of one raw
frame. The game declares `per_frame_draws`, so the vector env hands each
frame of a group and of the noop burn its own.

Columns wrap through the tunnel row with a floored modulo (`%` on
tensors, which is `torch.remainder`). The ghosts' points take 2 to an
integer power, exact in the reference's compiled power; the port builds
the power of two from its exponent bits.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from dqn_zoo_torch.envs import render
from dqn_zoo_torch.envs.api import Game, register_game

MAZE = (
    "WWWWWWWWWWWWWWWWWWW",
    "W........W........W",
    "WoWW.WWW.W.WWW.WWoW",
    "W.................W",
    "W.WW.W.WWWWW.W.WW.W",
    "W....W...W...W....W",
    "WWWW.WWW.W.WWW.WWWW",
    "WWWW.W       W.WWWW",
    "WWWW.W WW WW W.WWWW",  # the gap at column 9 is the ghost house door
    "    .  WGGGW  .    ",
    "WWWW.W WWWWW W.WWWW",
    "WWWW.W       W.WWWW",
    "WWWW.W WWWWW W.WWWW",
    "W........W........W",
    "W.WW.WWW.W.WWW.WW.W",
    "Wo.W.....P.....W.oW",
    "WW.W.W.WWWWW.W.W.WW",
    "W....W...W...W....W",
    "W.WWWWWW.W.WWWWWW.W",
    "W.................W",
    "WWWWWWWWWWWWWWWWWWW",
)

ROWS, COLS = len(MAZE), len(MAZE[0])  # 21 x 19
CELL = 8  # pixels per cell
Y0, X0 = 22, 4  # the maze's place in the frame
TUNNEL_ROW = 9
PLAYER_MOVE_PERIOD = 2  # raw frames per cell move
GHOST_MOVE_PERIOD = 2
FRIGHT_MOVE_PERIOD = 3  # frightened ghosts are slower
POWER_FRAMES = 360
LIVES = 3
EPISODE_FRAMES = 20000
PELLET_POINTS = 10.0
POWER_POINTS = 50.0
GHOST_POINTS = 200.0  # doubles a ghost within one power window
NUM_GHOSTS = 4
RANDOM_PICK_PROB = 0.25  # a ghost's move is a random pick this often
GHOST_COLORS = ((200, 72, 72), (198, 89, 179), (84, 184, 153), (180, 122, 48))
# Directions: up, right, down, left; 4 is stopped.
DR = (-1, 0, 1, 0, 0)
DC = (0, 1, 0, -1, 0)
REVERSE = (2, 3, 0, 1)
# The 9 actions (NOOP, UP, RIGHT, LEFT, DOWN, UPRIGHT, UPLEFT, DOWNRIGHT,
# DOWNLEFT) as a requested direction and a fallback: a diagonal asks for
# its horizontal part first.
PRIMARY = (4, 0, 1, 3, 2, 1, 3, 1, 3)
SECONDARY = (4, 0, 1, 3, 2, 0, 0, 2, 2)

GHOST_START = [(r, c) for r, row in enumerate(MAZE)
               for c, ch in enumerate(row) if ch == "G"]
GHOST_START += [GHOST_START[-1]] * (NUM_GHOSTS - len(GHOST_START))
PLAYER_START = [(r, c) for r, row in enumerate(MAZE)
                for c, ch in enumerate(row) if ch == "P"][0]
WALL_RGB, PELLET_RGB, POWER_RGB = (33, 33, 222), (110, 110, 110), \
    (228, 180, 180)
FRIGHT_RGB, PLAYER_RGB = (66, 114, 194), (252, 224, 112)


class MsPacmanState(NamedTuple):
  pr: torch.Tensor  # (B,) i32 player cell row
  pc: torch.Tensor  # (B,) i32
  pdir: torch.Tensor  # (B,) i32 in [0, 4], her heading (4: stopped)
  want: torch.Tensor  # (B,) i32 the last direction asked for
  gr: torch.Tensor  # (B, NUM_GHOSTS) i32
  gc: torch.Tensor  # (B, NUM_GHOSTS) i32
  gdir: torch.Tensor  # (B, NUM_GHOSTS) i32
  pellet: torch.Tensor  # (B, ROWS, COLS) bool
  power: torch.Tensor  # (B, ROWS, COLS) bool
  fright: torch.Tensor  # (B,) i32 frames of fright left
  combo: torch.Tensor  # (B,) i32 ghosts eaten this power window
  lives: torch.Tensor  # (B,) i32
  frame: torch.Tensor  # (B,) i32


class MsPacmanInitDraws(NamedTuple):
  batch: torch.Tensor  # (B,) i32 zeros: no draw, the batch and the device


class MsPacmanStepDraws(NamedTuple):
  score_u: torch.Tensor  # (B, NUM_GHOSTS, 4) U[0, 1): the direction noise
  pick_u: torch.Tensor  # (B, NUM_GHOSTS) U[0, 1): a random pick < 0.25


def ms_pacman_init_draws(gen, b, device) -> MsPacmanInitDraws:
  del gen  # every episode starts alike
  return MsPacmanInitDraws(
      batch=torch.zeros((b,), dtype=torch.int32, device=device))


def ms_pacman_step_draws(gen, b, device, frames: int) -> MsPacmanStepDraws:
  """The ghosts' draws of `frames` raw frames: (frames, B, ...) each."""
  return MsPacmanStepDraws(
      score_u=torch.rand((frames, b, NUM_GHOSTS, 4), generator=gen,
                         device=device),
      pick_u=torch.rand((frames, b, NUM_GHOSTS), generator=gen,
                        device=device))


class _Tables(NamedTuple):
  wall: torch.Tensor  # (ROWS, COLS) bool
  pellet: torch.Tensor  # (ROWS, COLS) bool, the full maze's pellets
  power: torch.Tensor  # (ROWS, COLS) bool
  dr: torch.Tensor  # (5,) i32
  dc: torch.Tensor  # (5,) i32
  reverse: torch.Tensor  # (4,) i32
  primary: torch.Tensor  # (9,) i32
  secondary: torch.Tensor  # (9,) i32
  ghost_r: torch.Tensor  # (1, NUM_GHOSTS) i32 start rows
  ghost_c: torch.Tensor  # (1, NUM_GHOSTS) i32
  palette: torch.Tensor  # (10, 3) u8, the grid's colours (see render)


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> _Tables:
  """The step's and the render's constant tensors on `device`, copied there
  once."""
  grid = lambda ch: torch.tensor([[x == ch for x in row] for row in MAZE],
                                 dtype=torch.bool, device=device)
  i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=device)
  return _Tables(
      wall=grid("W"), pellet=grid("."), power=grid("o"),
      dr=i32(DR), dc=i32(DC), reverse=i32(REVERSE), primary=i32(PRIMARY),
      secondary=i32(SECONDARY),
      ghost_r=i32([[r for r, _ in GHOST_START]]),
      ghost_c=i32([[c for _, c in GHOST_START]]),
      palette=torch.tensor(
          ((0, 0, 0), WALL_RGB, PELLET_RGB, POWER_RGB) + GHOST_COLORS
          + (FRIGHT_RGB, PLAYER_RGB), dtype=torch.uint8, device=device))


def ms_pacman_init(draws: MsPacmanInitDraws) -> MsPacmanState:
  b = draws.batch.shape[0]
  dev = draws.batch.device
  c = _tables(dev)
  i = lambda v, *s: torch.full((b,) + s, v, dtype=torch.int32, device=dev)
  return MsPacmanState(
      pr=i(PLAYER_START[0]), pc=i(PLAYER_START[1]), pdir=i(4), want=i(4),
      gr=c.ghost_r.expand(b, NUM_GHOSTS).clone(),
      gc=c.ghost_c.expand(b, NUM_GHOSTS).clone(),
      gdir=i(0, NUM_GHOSTS),
      pellet=c.pellet.expand(b, ROWS, COLS).clone(),
      power=c.power.expand(b, ROWS, COLS).clone(),
      fright=i(0), combo=i(0), lives=i(LIVES), frame=i(0))


def _pow2(e: torch.Tensor) -> torch.Tensor:
  """2 ** e in f32 for integer e >= -126, exact (inf from 128 on), from
  the exponent's bits."""
  bits = ((torch.clamp(e, max=128) + 127) << 23).to(torch.int32)
  return bits.view(torch.float32)


def ms_pacman_step(state: MsPacmanState, action: torch.Tensor,
                   draws: MsPacmanStepDraws):
  dev = state.pr.device
  c = _tables(dev)
  rows = torch.arange(state.pr.shape[0], device=dev)
  a = action.long()
  primary, secondary = c.primary[a], c.secondary[a]
  want = torch.where(primary == 4, state.want, primary)

  move_now = (state.frame % PLAYER_MOVE_PERIOD) == 0

  def open_cell(r, col):
    """The cell is a corridor; columns wrap through the tunnel row."""
    return ~c.wall[r.long(), (col % COLS).long()]

  # The direction asked for (the diagonal's fallback next), else the
  # heading kept, else a stop.
  def try_dir(d):
    return open_cell(state.pr + c.dr[d.long()],
                     state.pc + c.dc[d.long()]) & (d != 4)

  stop = torch.full_like(state.pdir, 4)
  pick = torch.where(
      try_dir(want), want,
      torch.where((primary != 4) & try_dir(secondary), secondary,
                  torch.where(try_dir(state.pdir), state.pdir, stop)))
  pdir = torch.where(move_now, pick, state.pdir)
  pr = torch.where(move_now, state.pr + c.dr[pdir.long()], state.pr)
  pc = torch.where(move_now, state.pc + c.dc[pdir.long()], state.pc) % COLS

  # Pellets under the player are eaten.
  at = (rows, pr.long(), pc.long())
  ate_pellet = state.pellet[at]
  ate_power = state.power[at]
  pellet = state.pellet.clone()
  power = state.power.clone()
  # Device values: a Python scalar here would be copied from the host.
  pellet[at] = torch.zeros_like(ate_pellet)
  power[at] = torch.zeros_like(ate_power)
  reward = ate_pellet * PELLET_POINTS + ate_power * POWER_POINTS
  fright = torch.where(ate_power, POWER_FRAMES,
                       torch.clamp(state.fright - 1, min=0))
  combo = torch.where(ate_power, 0, state.combo)

  # The ghosts, at their move tick, take the open direction (not back the
  # way they came, unless it is the only one) nearest the player, or
  # farthest from her while frightened; a quarter of the picks are random.
  frightened = fright > 0
  g_period = torch.where(frightened, FRIGHT_MOVE_PERIOD, GHOST_MOVE_PERIOD)
  g_move = (state.frame % g_period) == 1
  cand_r = state.gr[:, :, None] + c.dr[:4]  # (B, G, 4)
  cand_c = (state.gc[:, :, None] + c.dc[:4]) % COLS
  openc = ~c.wall[cand_r.long(), cand_c.long()]
  back = c.reverse[torch.clamp(state.gdir, 0, 3).long()]
  reverse = back[:, :, None] == torch.arange(4, device=dev)
  allowed = openc & (~reverse | (openc.sum(-1, keepdim=True) == 1))
  # The column distance wraps through the tunnel.
  dcol = torch.abs(cand_c - pc[:, None, None])
  dcol = torch.minimum(dcol, COLS - dcol)
  dist = torch.abs(cand_r - pr[:, None, None]) + dcol
  score = torch.where(frightened[:, None, None], -dist, dist)
  u = draws.score_u.to(torch.float32)
  rand_pick = (draws.pick_u < RANDOM_PICK_PROB)[:, :, None]
  score = torch.where(rand_pick, u * 10.0, score.to(torch.float32) + u * 0.5)
  score = torch.where(allowed, score, torch.inf)
  gdir_new = torch.argmin(score, dim=-1).to(torch.int32)
  g_move = g_move[:, None]
  gdir = torch.where(g_move, gdir_new, state.gdir)
  gr = torch.where(g_move, state.gr + c.dr[gdir.long()], state.gr)
  gc = torch.where(g_move, state.gc + c.dc[gdir.long()], state.gc) % COLS

  # Contacts: the same cell, or cells swapped this frame.
  pr_, pc_ = pr[:, None], pc[:, None]
  same = (gr == pr_) & (gc == pc_)
  swapped = ((gr == state.pr[:, None]) & (gc == state.pc[:, None])
             & (state.gr == pr_) & (state.gc == pc_))
  contact = same | swapped

  # A frightened ghost caught is eaten (the points double with each one)
  # and sent home.
  eat = contact & frightened[:, None]
  exponent = combo[:, None] + torch.cumsum(eat, dim=1) - 1
  gains = GHOST_POINTS * _pow2(exponent) * eat
  reward = reward + gains.sum(dim=1)
  combo = combo + eat.sum(dim=1).to(torch.int32)
  home_r, home_c = GHOST_START[0]
  gr = torch.where(eat, home_r, gr)
  gc = torch.where(eat, home_c, gc)

  # A ghost that is not frightened costs a life; all return to the start.
  died = (contact & ~frightened[:, None]).any(dim=1)
  lives = state.lives - died.to(torch.int32)
  d1, d2 = died, died[:, None]
  pr = torch.where(d1, PLAYER_START[0], pr)
  pc = torch.where(d1, PLAYER_START[1], pc)
  gr = torch.where(d2, c.ghost_r, gr)
  gc = torch.where(d2, c.ghost_c, gc)
  pdir = torch.where(d1, 4, pdir)
  fright = torch.where(d1, 0, fright)

  # A cleared maze refills.
  cleared = ~(pellet.any(dim=(1, 2)) | power.any(dim=(1, 2)))[:, None, None]
  pellet = torch.where(cleared, c.pellet, pellet)
  power = torch.where(cleared, c.power, power)

  frame = state.frame + 1
  done = (lives <= 0) | (frame >= EPISODE_FRAMES)
  life_lost = died & (lives > 0)
  new_state = MsPacmanState(pr, pc, pdir, want, gr, gc, gdir, pellet, power,
                            fright, combo, lives, frame)
  return new_state, reward, done, life_lost


def ms_pacman_render(state: MsPacmanState) -> torch.Tensor:
  """The cell grid's colours, 8x upsampled and placed at (22, 4); the
  ghosts are painted in order over the pellets (a later ghost over an
  earlier one), the player over them, and the lives bar below."""
  b = state.pr.shape[0]
  dev = state.pr.device
  c = _tables(dev)
  rows = torch.arange(b, device=dev)
  # Palette indices: 0 floor, 1 wall, 2 pellet, 3 power pellet, 4-7 the
  # ghosts, 8 a frightened ghost, 9 the player.
  index = c.wall.to(torch.int64).expand(b, ROWS, COLS).clone()
  index.masked_fill_(state.pellet, 2)
  index.masked_fill_(state.power, 3)
  frightened = state.fright > 0
  for g in range(NUM_GHOSTS):
    index[rows, state.gr[:, g].long(), state.gc[:, g].long()] = \
        torch.where(frightened, 8, 4 + g)
  index[rows, state.pr.long(), state.pc.long()] = torch.full_like(rows, 9)
  big = c.palette[index].repeat_interleave(CELL, dim=1).repeat_interleave(
      CELL, dim=2)
  frame = torch.zeros((b, 210, 160, 3), dtype=torch.uint8, device=dev)
  frame[:, Y0:Y0 + ROWS * CELL, X0:X0 + COLS * CELL] = big
  lives_bar = render.rect_mask(200, 206, 8, 8 + 10 * state.lives, dev)
  # A select, not a masked write: that would read the mask on the host.
  return torch.where(lives_bar[..., None], c.palette[9], frame)


def ms_pacman_lives(state: MsPacmanState) -> torch.Tensor:
  return state.lives


GAME = register_game(Game(
    name="ms_pacman",
    num_actions=9,
    init=ms_pacman_init,
    step=ms_pacman_step,
    render=ms_pacman_render,
    lives=ms_pacman_lives,
    init_draws=ms_pacman_init_draws,
    step_draws=ms_pacman_step_draws,
    per_frame_draws=True,
))
