"""Fishing Derby, batched (port of dqn_zoo_tpu/envs/games/fishing_derby.py).

Same constants, update order, float expressions and colours as the
reference: six lanes of fish swim across the pond, a free hook bites the
first fish it overlaps, the line rises only while UP is held and the fish
may shake off otherwise, a landed fish pays its lane's value (the shark's
band lies above the landing line, so it never steals one, as in the
reference), a scripted opponent scores 4 every 110 frames, the first to 99
(or 12,000 frames) ends the episode, no lives, the 18 joystick actions.
The reference splits a key carried in the state at init (the fish's
columns and headings) and twice in a row on every raw frame (the escape
test, then the respawn edge); here the state carries no key, `init` takes
`FishingDerbyInitDraws` and `step` takes `FishingDerbyStepDraws`, the
draws of one raw frame. The game declares `per_frame_draws`, so the vector
env hands each frame of a group and of the noop burn its own.

The lanes' speed ramp `0.8 + 0.1 i` is the reference's compiled
arithmetic: XLA neither folds it nor fuses it into a multiply-add, and
rounds the product and the sum apart (lane 5 swims at 1.3, where one
multiply-add would give 1.3000001).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from dqn_zoo_torch.envs import render
from dqn_zoo_torch.envs.api import Game, register_game
from dqn_zoo_torch.envs.games import isin

WATER_TOP = 84.0
NUM_LANES = 6
LANE_DY = 18.0
LANE_VALUES = (2.0, 2.0, 4.0, 4.0, 6.0, 6.0)  # deeper is worth more
FISH_W, FISH_H = 12, 6
HOOK_X_MIN, HOOK_X_MAX = 20.0, 72.0  # the player's half of the pond
HOOK_SPEED = 2.0
REEL_SPEED = 2.5
SHARK_Y = 70.0
SHARK_SPEED = 1.6
SHARK_W = 18
OPP_CATCH_EVERY = 110  # frames per opponent catch
OPP_VALUE = 4.0  # the opponent's catch
TARGET = 99.0
EPISODE_FRAMES = 12000
ESCAPE_PROB = 0.05  # a hooked fish not reeled in shakes off, a frame

UP_ACTIONS = (2, 6, 7, 10, 14, 15)
DOWN_ACTIONS = (5, 8, 9, 13, 16, 17)
LEFT_ACTIONS = (4, 7, 9, 12, 15, 17)
RIGHT_ACTIONS = (3, 6, 8, 11, 14, 16)


def lane_y(i: int) -> float:
  return WATER_TOP + 14.0 + i * LANE_DY


class FishingDerbyState(NamedTuple):
  hook_x: torch.Tensor  # (B,) f32
  hook_y: torch.Tensor  # (B,) f32
  hooked_lane: torch.Tensor  # (B,) i32, -1: nothing on the line
  fish_x: torch.Tensor  # (B, NUM_LANES) f32
  fish_dir: torch.Tensor  # (B, NUM_LANES) f32 ±1
  shark_x: torch.Tensor  # (B,) f32
  shark_dir: torch.Tensor  # (B,) f32
  my_score: torch.Tensor  # (B,) f32
  opp_score: torch.Tensor  # (B,) f32
  frame: torch.Tensor  # (B,) i32


class FishingDerbyInitDraws(NamedTuple):
  fish_x: torch.Tensor  # (B, NUM_LANES) f32 in [10, 150)
  fish_right: torch.Tensor  # (B, NUM_LANES) bool, the fish swims right


class FishingDerbyStepDraws(NamedTuple):
  escape: torch.Tensor  # (B,) bool, true with ESCAPE_PROB
  left_edge: torch.Tensor  # (B,) bool: a new fish enters at 10, else 150


def fishing_derby_init_draws(gen, b, device) -> FishingDerbyInitDraws:
  shape = (b, NUM_LANES)
  u = torch.rand(shape, generator=gen, device=device)
  return FishingDerbyInitDraws(
      fish_x=u * 140.0 + 10.0,
      fish_right=torch.rand(shape, generator=gen, device=device) < 0.5)


def fishing_derby_step_draws(gen, b, device,
                             frames: int) -> FishingDerbyStepDraws:
  """The escape tests and respawn edges of `frames` raw frames: (frames,
  B) each."""
  rand = lambda: torch.rand((frames, b), generator=gen, device=device)
  return FishingDerbyStepDraws(escape=rand() < ESCAPE_PROB,
                               left_edge=rand() < 0.5)


def fishing_derby_init(draws: FishingDerbyInitDraws) -> FishingDerbyState:
  b = draws.fish_x.shape[0]
  dev = draws.fish_x.device
  f = lambda v: torch.full((b,), v, dtype=torch.float32, device=dev)
  return FishingDerbyState(
      hook_x=f(46.0),
      hook_y=f(WATER_TOP + 10.0),
      hooked_lane=torch.full((b,), -1, dtype=torch.int32, device=dev),
      fish_x=draws.fish_x.to(torch.float32),
      fish_dir=torch.where(draws.fish_right, 1.0, -1.0).to(torch.float32),
      shark_x=f(80.0),
      shark_dir=f(1.0),
      my_score=f(0.0),
      opp_score=f(0.0),
      frame=torch.zeros((b,), dtype=torch.int32, device=dev),
  )


class _Tables(NamedTuple):
  lanes: torch.Tensor  # (1, NUM_LANES) i32
  ramp: torch.Tensor  # (1, NUM_LANES) f32, each lane's swim speed
  lane_ys: torch.Tensor  # (1, NUM_LANES) f32
  values: torch.Tensor  # (NUM_LANES,) f32
  scenery: tuple  # the water's and the piers' (mask, rgb) layers
  fish: torch.Tensor  # (NUM_LANES, 210) bool, each lane's rows


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> _Tables:
  """The step's and the render's constant tensors on `device`, copied there
  once."""
  mask = lambda *box: render.rect_mask(*box, device)
  lanes = torch.arange(NUM_LANES, dtype=torch.int32, device=device)
  rows = torch.arange(210, dtype=torch.int32, device=device)
  fish = torch.stack([
      (rows >= int(lane_y(i) - FISH_H / 2)) & (rows < int(lane_y(i)
                                                          + FISH_H / 2))
      for i in range(NUM_LANES)])
  wt = int(WATER_TOP)
  return _Tables(
      lanes=lanes[None],
      ramp=(lanes.to(torch.float32) * 0.1 + 0.8)[None],
      lane_ys=torch.tensor([lane_y(i) for i in range(NUM_LANES)],
                           dtype=torch.float32, device=device)[None],
      values=torch.tensor(LANE_VALUES, dtype=torch.float32, device=device),
      scenery=((mask(wt, 210, 0, 160), (40, 80, 160)),
               (mask(60, wt, 8, 36), (150, 110, 70)),
               (mask(60, wt, 124, 152), (150, 110, 70))),
      fish=fish)


def fishing_derby_step(state: FishingDerbyState, action: torch.Tensor,
                       draws: FishingDerbyStepDraws):
  c = _tables(state.hook_x.device)
  frame = state.frame + 1
  up = isin(action, UP_ACTIONS)
  down = isin(action, DOWN_ACTIONS)
  left = isin(action, LEFT_ACTIONS)
  right = isin(action, RIGHT_ACTIONS)
  zero = torch.zeros_like(state.hook_x)

  # The fish swim, and turn at the pond's edges.
  fish_x = state.fish_x + state.fish_dir * c.ramp
  fish_dir = torch.where((fish_x < 6.0) | (fish_x > 154.0),
                         -state.fish_dir, state.fish_dir)
  fish_x = torch.clamp(fish_x, 6.0, 154.0)

  # The shark patrols the surface.
  shark_x = state.shark_x + state.shark_dir * SHARK_SPEED
  shark_dir = torch.where((shark_x < 10.0) | (shark_x > 140.0),
                          -state.shark_dir, state.shark_dir)
  shark_x = torch.clamp(shark_x, 10.0, 140.0)

  reeling = state.hooked_lane >= 0
  # A free hook steers; a hooked line rises only while UP is held and
  # sinks back otherwise, when the fish may shake off.
  dx = torch.where(left, -HOOK_SPEED, zero) \
      + torch.where(right, HOOK_SPEED, zero)
  dy = torch.where(up, -HOOK_SPEED, zero) + torch.where(down, HOOK_SPEED, zero)
  hook_x = torch.clamp(state.hook_x + dx, HOOK_X_MIN, HOOK_X_MAX)
  low, high = WATER_TOP + 4.0, lane_y(NUM_LANES - 1) + 6.0
  hook_y = torch.where(
      reeling,
      torch.clamp(state.hook_y + torch.where(up, -REEL_SPEED, 1.2), low,
                  high),
      torch.clamp(state.hook_y + dy, low, high))
  escaped = reeling & ~up & draws.escape

  # A free hook bites the first fish it overlaps.
  overlap = ((torch.abs(fish_x - hook_x[:, None]) < FISH_W / 2 + 2)
             & (torch.abs(c.lane_ys - hook_y[:, None]) < FISH_H / 2 + 3))
  bite = ~reeling & overlap.any(dim=1)
  bit_lane = torch.argmax(overlap.to(torch.uint8), dim=1).to(torch.int32)
  hooked_lane = torch.where(bite, bit_lane, state.hooked_lane)

  # A hooked fish rides the line.
  on_line = (c.lanes == hooked_lane[:, None]) & (hooked_lane >= 0)[:, None]
  fish_x = torch.where(on_line, hook_x[:, None], fish_x)

  # Landing: the line reaches the surface with a fish on; the shark would
  # steal one that crosses its mouth below the landing line (none can).
  hooked = hooked_lane >= 0
  landed = hooked & (hook_y <= WATER_TOP + 4.0)
  stolen = (hooked & (hook_y <= SHARK_Y + 8.0)
            & (torch.abs(shark_x + SHARK_W / 2 - hook_x) < SHARK_W / 2 + 2)
            & ~landed)
  value = c.values[torch.clamp(hooked_lane, 0, NUM_LANES - 1).long()]
  reward = torch.where(landed, value, zero)
  my_score = state.my_score + torch.where(landed, value, zero)
  # A landed or stolen fish comes back at a random edge.
  respawn_x = torch.where(draws.left_edge, 10.0, 150.0).to(torch.float32)
  fish_x = torch.where(on_line & (landed | stolen)[:, None],
                       respawn_x[:, None], fish_x)
  hooked_lane = torch.where(landed | stolen | escaped, -1, hooked_lane)
  hook_y = torch.where(landed | stolen, WATER_TOP + 10.0, hook_y)

  # The opponent, a competent scripted angler, scores steadily.
  opp_scores = (frame % OPP_CATCH_EVERY) == 0
  reward = reward - torch.where(opp_scores, OPP_VALUE, zero)
  opp_score = state.opp_score + torch.where(opp_scores, OPP_VALUE, zero)

  done = (my_score >= TARGET) | (opp_score >= TARGET) \
      | (frame >= EPISODE_FRAMES)
  new_state = FishingDerbyState(hook_x, hook_y, hooked_lane, fish_x,
                                fish_dir, shark_x, shark_dir, my_score,
                                opp_score, frame)
  return new_state, reward, done, torch.zeros_like(done)


def fishing_derby_render(state: FishingDerbyState) -> torch.Tensor:
  b = state.hook_x.shape[0]
  dev = state.hook_x.device
  c = _tables(dev)
  rect = lambda *box: render.rect_mask(*box, dev)
  hx, hy = state.hook_x, state.hook_y
  line = rect(int(WATER_TOP) - 10, hy + 2, hx - 1, hx + 1)
  hook = rect(hy - 2, hy + 3, hx - 2, hx + 3)
  # Each lane's fish: its rows (a constant) by its columns.
  cols = torch.arange(160, dtype=torch.int32, device=dev)
  x0 = (state.fish_x - FISH_W / 2).to(torch.int32)[..., None]
  x1 = (state.fish_x + FISH_W / 2).to(torch.int32)[..., None]
  in_cols = (cols >= x0) & (cols < x1)  # (B, NUM_LANES, 160)
  fish = (c.fish[None, :, :, None] & in_cols[:, :, None, :]).any(dim=1)
  shark = rect(int(SHARK_Y), int(SHARK_Y) + 10, state.shark_x,
               state.shark_x + SHARK_W)
  my_bar = rect(20, 26, 8, 8 + state.my_score)
  opp_bar = rect(30, 36, 8, 8 + state.opp_score)
  return render.compose(
      b, dev, (120, 170, 220),  # sky
      *c.scenery,
      (fish, (220, 220, 120)),
      (shark, (90, 90, 100)),
      (line, (230, 230, 230)),
      (hook, (250, 250, 250)),
      (my_bar, (240, 240, 240)),
      (opp_bar, (240, 160, 60)),
  )


def fishing_derby_lives(state: FishingDerbyState) -> torch.Tensor:
  return torch.ones_like(state.frame)


GAME = register_game(Game(
    name="fishing_derby",
    num_actions=18,
    init=fishing_derby_init,
    step=fishing_derby_step,
    render=fishing_derby_render,
    lives=fishing_derby_lives,
    init_draws=fishing_derby_init_draws,
    step_draws=fishing_derby_step_draws,
    per_frame_draws=True,
))
