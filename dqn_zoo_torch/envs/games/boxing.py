"""Boxing, batched (port of dqn_zoo_tpu/envs/games/boxing.py).

Same constants, update order, float expressions and colours as the
reference: two boxers in a ring, 18 actions, +1 a punch landed and -1 a
punch taken, no lives; a bout ends on the 7,200-frame clock or a 100-hit
KO. The reference splits a key carried in the state at init (the boxers'
vertical jitter, the enemy's first cooldown) and on every raw frame (the
enemy's feint test); here the state carries no key, `init` takes
`BoxingInitDraws` and `step` takes `BoxingStepDraws`, the draws of one raw
frame. The game declares `per_frame_draws`, so the vector env hands each
frame of a group and of the noop burn its own.

The gloves' boxes take the reference's compiled arithmetic: XLA folds
`(y + 6) + 4` into `y + 10`.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from dqn_zoo_torch.envs import render
from dqn_zoo_torch.envs.api import Game, register_game

# Ring interior (pixels).
RING_TOP = 45.0
RING_BOTTOM = 178.0
RING_LEFT = 32.0
RING_RIGHT = 124.0
BOXER_W, BOXER_H = 8, 22
PLAYER_SPEED = 2.0
ENEMY_SPEED = 1.4  # slower than the player: range control is learnable
REACH = 14.0  # glove extension beyond the body box
PUNCH_FRAMES = 4  # glove extended this many frames
COOLDOWN = 24  # frames between punches (either boxer)
ALIGN_Y = 14.0  # vertical alignment window for a punch to land
KO_HITS = 100
EPISODE_FRAMES = 7200  # 2 minutes at 60 Hz, the bout clock
FEINT_PROB = 0.25  # an enemy that may punch does so with this probability
# Start row of both boxers before their jitter, a Python float.
Y0 = (RING_TOP + RING_BOTTOM) / 2 - BOXER_H / 2

# The full action set's directions (NOOP FIRE UP RIGHT LEFT DOWN UR UL DR DL
# UF RF LF DF URF ULF DRF DLF).
_UP = (2, 6, 7, 10, 14, 15)
_DOWN = (5, 8, 9, 13, 16, 17)
_RIGHT = (3, 6, 8, 11, 14, 16)
_LEFT = (4, 7, 9, 12, 15, 17)


class BoxingState(NamedTuple):
  px: torch.Tensor  # (B,) f32, player body left edge
  py: torch.Tensor  # (B,) f32
  ex: torch.Tensor  # (B,) f32, enemy
  ey: torch.Tensor  # (B,) f32
  p_punch: torch.Tensor  # (B,) i32, frames of extension left (0: retracted)
  e_punch: torch.Tensor  # (B,) i32
  p_cool: torch.Tensor  # (B,) i32, frames until the next punch is allowed
  e_cool: torch.Tensor  # (B,) i32
  p_hits: torch.Tensor  # (B,) i32, punches landed by the player
  e_hits: torch.Tensor  # (B,) i32
  frame: torch.Tensor  # (B,) i32


class BoxingInitDraws(NamedTuple):
  jitter: torch.Tensor  # (B, 2) f32 in [-16, 16): player's, enemy's row
  e_cool: torch.Tensor  # (B,) int in [0, COOLDOWN)


class BoxingStepDraws(NamedTuple):
  feint: torch.Tensor  # (B,) bool, true with FEINT_PROB: the enemy punches


def boxing_init_draws(gen, b, device) -> BoxingInitDraws:
  u = torch.rand((b, 2), generator=gen, device=device)
  return BoxingInitDraws(
      jitter=u * 32.0 - 16.0,
      e_cool=torch.randint(0, COOLDOWN, (b,), generator=gen, device=device,
                           dtype=torch.int32))


def boxing_step_draws(gen, b, device, frames: int) -> BoxingStepDraws:
  """The feint draws of `frames` raw frames: (frames, B)."""
  return BoxingStepDraws(feint=torch.rand(
      (frames, b), generator=gen, device=device) < FEINT_PROB)


def boxing_init(draws: BoxingInitDraws) -> BoxingState:
  jitter = draws.jitter.to(torch.float32)
  b = jitter.shape[0]
  dev = jitter.device
  f = lambda v: torch.full((b,), v, dtype=torch.float32, device=dev)
  i = lambda: torch.zeros((b,), dtype=torch.int32, device=dev)
  return BoxingState(
      px=f(RING_LEFT + 12.0),
      py=f(Y0) + jitter[:, 0],
      ex=f(RING_RIGHT - 12.0 - BOXER_W),
      ey=f(Y0) + jitter[:, 1],
      p_punch=i(),
      e_punch=i(),
      p_cool=i(),
      e_cool=draws.e_cool.to(torch.int32),
      p_hits=i(),
      e_hits=i(),
      frame=i(),
  )


class _Tables(NamedTuple):
  up: torch.Tensor  # (18,) bool by action
  down: torch.Tensor
  right: torch.Tensor
  left: torch.Tensor
  scenery: tuple  # (mask, rgb) layers that never move


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> _Tables:
  """The step's and the render's constant tensors on `device`, copied there
  once."""
  member = lambda ids: torch.tensor([a in ids for a in range(18)],
                                    dtype=torch.bool, device=device)
  mask = lambda *box: render.rect_mask(*(int(v) for v in box), device)
  outer = RING_RIGHT + 8 + BOXER_W
  mat = mask(RING_TOP - 6, RING_BOTTOM + 6, RING_LEFT - 8, outer)
  ropes = (mask(RING_TOP - 6, RING_TOP - 4, RING_LEFT - 8, outer)
           | mask(RING_BOTTOM + 4, RING_BOTTOM + 6, RING_LEFT - 8, outer))
  return _Tables(up=member(_UP), down=member(_DOWN), right=member(_RIGHT),
                 left=member(_LEFT),
                 scenery=((mat, (160, 171, 191)), (ropes, (214, 214, 214))))


def boxing_step(state: BoxingState, action: torch.Tensor,
                draws: BoxingStepDraws):
  c = _tables(state.px.device)
  action = action.long()
  dx = c.right[action].to(torch.float32) - c.left[action].to(torch.float32)
  dy = c.down[action].to(torch.float32) - c.up[action].to(torch.float32)
  fire = (action == 1) | (action >= 10)
  px = torch.clamp(state.px + dx * PLAYER_SPEED, RING_LEFT,
                   RING_RIGHT - BOXER_W)
  py = torch.clamp(state.py + dy * PLAYER_SPEED, RING_TOP,
                   RING_BOTTOM - BOXER_H)

  # Enemy AI: close the horizontal gap to just inside its reach, align
  # vertically, and counterpunch when aligned and in range.
  zero = torch.zeros_like(px)
  gap = px + BOXER_W - state.ex  # player's right edge vs enemy's left edge
  want_x = torch.where(gap < -REACH + 2.0, -ENEMY_SPEED,
                       torch.where(gap > -4.0, ENEMY_SPEED, zero))
  want_y = torch.clamp(py - state.ey, -ENEMY_SPEED, ENEMY_SPEED)
  ex = torch.clamp(state.ex + want_x, RING_LEFT, RING_RIGHT - BOXER_W)
  ey = torch.clamp(state.ey + want_y, RING_TOP, RING_BOTTOM - BOXER_H)

  aligned = torch.abs(py - ey) <= ALIGN_Y
  dist = ex - (px + BOXER_W)  # horizontal daylight between the bodies

  # Punch starts: the player on FIRE, the enemy when its cooldown allows,
  # the player is inside its reach and the feint draw says so.
  p_start = fire & (state.p_cool <= 0)
  e_wants = aligned & (dist <= REACH) & (state.e_cool <= 0)
  e_start = e_wants & draws.feint

  dec = lambda v: torch.clamp(v - 1, min=0)
  p_punch = torch.where(p_start, PUNCH_FRAMES, dec(state.p_punch))
  e_punch = torch.where(e_start, PUNCH_FRAMES, dec(state.e_punch))
  p_cool = torch.where(p_start, COOLDOWN, dec(state.p_cool))
  e_cool = torch.where(e_start, COOLDOWN, dec(state.e_cool))

  # A punch lands on the frame it starts, if aligned and in reach, and
  # shoves the opponent back a step; the player's lands first in a trade.
  p_lands = p_start & aligned & (dist <= REACH)
  e_lands = e_start & aligned & (dist <= REACH) & ~p_lands
  ex = torch.where(p_lands, torch.clamp(ex + 6.0, RING_LEFT,
                                        RING_RIGHT - BOXER_W), ex)
  px = torch.where(e_lands, torch.clamp(px - 6.0, RING_LEFT,
                                        RING_RIGHT - BOXER_W), px)

  p_hits = state.p_hits + p_lands.to(torch.int32)
  e_hits = state.e_hits + e_lands.to(torch.int32)
  reward = p_lands.to(torch.float32) - e_lands.to(torch.float32)

  frame = state.frame + 1
  done = ((frame >= EPISODE_FRAMES) | (p_hits >= KO_HITS)
          | (e_hits >= KO_HITS))

  new_state = BoxingState(px, py, ex, ey, p_punch, e_punch, p_cool, e_cool,
                          p_hits, e_hits, frame)
  return new_state, reward, done, torch.zeros_like(done)


def boxing_render(state: BoxingState) -> torch.Tensor:
  b = state.px.shape[0]
  dev = state.px.device
  c = _tables(dev)
  rect = lambda *box: render.rect_mask(*box, dev)
  player = rect(state.py, state.py + BOXER_H, state.px, state.px + BOXER_W)
  enemy = rect(state.ey, state.ey + BOXER_H, state.ex, state.ex + BOXER_W)
  # Extended gloves (the player punches rightward, the enemy leftward); the
  # glove rows are y + 6 and y + 10, as XLA folds (y + 6) + 4.
  p_ext = torch.where(state.p_punch > 0, REACH, 3.0)
  p_glove = rect(state.py + 6, state.py + 10, state.px + BOXER_W,
                 state.px + BOXER_W + p_ext)
  e_ext = torch.where(state.e_punch > 0, REACH, 3.0)
  e_glove = rect(state.ey + 6, state.ey + 10, state.ex - e_ext, state.ex)
  # Score tally bars at the top (white left = player, black right = enemy).
  p_bar = rect(16, 22, 16, 16 + torch.clamp(state.p_hits, max=64))
  e_bar = rect(16, 22, 144 - torch.clamp(state.e_hits, max=64), 144)
  return render.compose(
      b, dev, (110, 156, 66),
      *c.scenery,
      (p_glove, (236, 236, 236)),
      (e_glove, (52, 52, 52)),
      (player, (252, 252, 252)),
      (enemy, (20, 20, 20)),
      (p_bar, (252, 252, 252)),
      (e_bar, (20, 20, 20)),
  )


def boxing_lives(state: BoxingState) -> torch.Tensor:
  return torch.ones_like(state.frame)


GAME = register_game(Game(
    name="boxing",
    num_actions=18,
    init=boxing_init,
    step=boxing_step,
    render=boxing_render,
    lives=boxing_lives,
    init_draws=boxing_init_draws,
    step_draws=boxing_step_draws,
    per_frame_draws=True,
))
