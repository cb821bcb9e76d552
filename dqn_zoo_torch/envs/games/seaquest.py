"""Seaquest, batched (port of dqn_zoo_tpu/envs/games/seaquest.py).

Same constants, 18-action tables, update order, float expressions and
colours as the reference. The reference splits a key carried in the state
at init and on every raw frame; here the state carries no key, `init` takes
`SeaquestInitDraws` and `step` takes `SeaquestStepDraws`: the diver-spawn
uniforms of one raw frame. An idle lane may spawn a diver on any frame, so
the game declares `per_frame_draws` and the vector env hands every frame of
a group and of the noop burn its own draws.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from dqn_zoo_torch.envs import render
from dqn_zoo_torch.envs.api import Game, register_game

NUM_LANES = 4
LANE_YS = (80.0, 110.0, 140.0, 170.0)
LANE_DIRS = (1.0, -1.0, 1.0, -1.0)  # march direction per lane
SURFACE_Y = 50.0  # player_y <= this means "at the surface"
SKY_BOTTOM = 46
PLAYER_W, PLAYER_H = 16.0, 8.0
PLAYER_SPEED = 2.0
PLAYER_X0, PLAYER_Y0 = 72.0, 46.0  # spawn: surfaced, mid-screen
X_MIN, X_MAX = 8.0, 152.0 - PLAYER_W
Y_MIN, Y_MAX = 46.0, 180.0
ENEMY_W, ENEMY_H = 12.0, 7.0
ENEMY_BASE_SPEED = 1.0
ENEMY_SPEED_PER_LEVEL = 0.3
ENEMY_RESPAWN_FRAMES = 40
DIVER_W, DIVER_H = 8.0, 7.0
DIVER_SPEED = 0.5
DIVER_SPAWN_PROB = 0.008  # per lane per raw frame
MAX_DIVERS = 6
TORPEDO_W, TORPEDO_H, TORPEDO_SPEED = 6.0, 2.0, 4.0
OXYGEN_MAX = 360.0  # raw frames of air (~90 agent-steps)
OXYGEN_REFILL_RATE = 8.0
LIVES = 4  # ALE seaquest starts with 4 lives
INVULN_FRAMES = 30
KILL_POINTS = 20.0
DIVER_CASH_POINTS = 50.0

# Per-action movement tables for the full 18-action ALE set: NOOP, FIRE,
# UP, RIGHT, LEFT, DOWN, UPRIGHT, UPLEFT, DOWNRIGHT, DOWNLEFT, then the
# same eight directions with FIRE.
_DX = (0, 0, 0, 1, -1, 0, 1, -1, 1, -1, 0, 1, -1, 0, 1, -1, 1, -1)
_DY = (0, 0, -1, 0, 0, 1, -1, -1, 1, 1, -1, 0, 0, 1, -1, -1, 1, 1)


class SeaquestState(NamedTuple):
  player_x: torch.Tensor  # (B,) f32, left edge
  player_y: torch.Tensor  # (B,) f32, top edge
  facing: torch.Tensor  # (B,) f32 ±1, torpedo direction
  torp_x: torch.Tensor  # (B,) f32
  torp_y: torch.Tensor  # (B,) f32
  torp_dir: torch.Tensor  # (B,) f32 ±1
  torp_live: torch.Tensor  # (B,) bool
  enemy_x: torch.Tensor  # (B, NUM_LANES) f32, left edge
  enemy_live: torch.Tensor  # (B, NUM_LANES) bool
  enemy_respawn: torch.Tensor  # (B, NUM_LANES) i32 frames until respawn
  diver_x: torch.Tensor  # (B, NUM_LANES) f32
  diver_live: torch.Tensor  # (B, NUM_LANES) bool
  divers_held: torch.Tensor  # (B,) i32, 0..6
  oxygen: torch.Tensor  # (B,) f32, 0..OXYGEN_MAX
  was_surfaced: torch.Tensor  # (B,) bool — previous frame at surface
  lives: torch.Tensor  # (B,) i32
  level: torch.Tensor  # (B,) i32 — completed 6-diver cash-ins
  invuln: torch.Tensor  # (B,) i32 — post-hit grace frames


class SeaquestInitDraws(NamedTuple):
  enemy_x: torch.Tensor  # (B, NUM_LANES) f32 in [8, 140)
  diver_u: torch.Tensor  # (B, NUM_LANES) U[0, 1): a diver where < 0.25


class SeaquestStepDraws(NamedTuple):
  spawn_u: torch.Tensor  # (B, NUM_LANES) U[0, 1): an idle lane's spawn test


def seaquest_init_draws(gen, b, device) -> SeaquestInitDraws:
  enemy_u = torch.rand((b, NUM_LANES), generator=gen, device=device)
  return SeaquestInitDraws(
      enemy_x=enemy_u * (140.0 - 8.0) + 8.0,
      diver_u=torch.rand((b, NUM_LANES), generator=gen, device=device))


def seaquest_step_draws(gen, b, device, frames: int) -> SeaquestStepDraws:
  """The spawn uniforms of `frames` raw frames: (frames, B, NUM_LANES)."""
  return SeaquestStepDraws(spawn_u=torch.rand(
      (frames, b, NUM_LANES), generator=gen, device=device))


def seaquest_init(draws: SeaquestInitDraws) -> SeaquestState:
  b = draws.enemy_x.shape[0]
  dev = draws.enemy_x.device
  f = lambda v: torch.full((b,), v, dtype=torch.float32, device=dev)
  i = lambda v: torch.full((b,), v, dtype=torch.int32, device=dev)
  lanes = (b, NUM_LANES)
  return SeaquestState(
      player_x=f(PLAYER_X0),
      player_y=f(PLAYER_Y0),
      facing=f(1.0),
      torp_x=f(0.0),
      torp_y=f(0.0),
      torp_dir=f(1.0),
      torp_live=torch.zeros((b,), dtype=torch.bool, device=dev),
      enemy_x=draws.enemy_x.to(torch.float32),
      enemy_live=torch.ones(lanes, dtype=torch.bool, device=dev),
      enemy_respawn=torch.zeros(lanes, dtype=torch.int32, device=dev),
      diver_x=torch.zeros(lanes, dtype=torch.float32, device=dev),
      diver_live=draws.diver_u < 0.25,
      divers_held=i(0),
      oxygen=f(OXYGEN_MAX),
      was_surfaced=torch.ones((b,), dtype=torch.bool, device=dev),
      lives=i(LIVES),
      level=i(0),
      invuln=i(0),
  )


class _Tables(NamedTuple):
  dx: torch.Tensor  # (18,) f32, _DX
  dy: torch.Tensor  # (18,) f32, _DY
  lane_ys: torch.Tensor  # (1, NUM_LANES) f32
  lane_dirs: torch.Tensor  # (1, NUM_LANES) f32
  enemy_entry: torch.Tensor  # (1, NUM_LANES) f32, x where a shark enters
  diver_entry: torch.Tensor  # (1, NUM_LANES) f32, x where a diver enters


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> _Tables:
  """The step's constant tensors on `device`, copied there once: a copy
  from the host waits for the card, and a step runs 34 raw frames a
  group."""
  t = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
  lane_dirs = t(LANE_DIRS)[None, :]
  return _Tables(
      dx=t(_DX), dy=t(_DY), lane_ys=t(LANE_YS)[None, :], lane_dirs=lane_dirs,
      enemy_entry=torch.where(lane_dirs > 0, -ENEMY_W, 160.0),
      diver_entry=torch.where(lane_dirs > 0, 160.0, -DIVER_W))


def seaquest_step(state: SeaquestState, action: torch.Tensor,
                  draws: SeaquestStepDraws):
  c = _tables(state.player_x.device)
  dx = c.dx[action] * PLAYER_SPEED
  dy = c.dy[action] * PLAYER_SPEED
  fire = (action == 1) | (action >= 10)
  player_x = torch.clamp(state.player_x + dx, X_MIN, X_MAX)
  player_y = torch.clamp(state.player_y + dy, Y_MIN, Y_MAX)
  facing = torch.where(dx != 0, torch.sign(dx), state.facing)
  surfaced = player_y <= SURFACE_Y
  reward = torch.zeros_like(player_x)
  lane_ys, lane_dirs = c.lane_ys, c.lane_dirs

  # Enemies march across their lanes, wrapping; dead lanes respawn off the
  # entry wall after a delay. Speed ramps with the level.
  speed = ENEMY_BASE_SPEED + ENEMY_SPEED_PER_LEVEL * state.level.to(
      torch.float32)
  enemy_x = state.enemy_x + lane_dirs * speed[:, None] * state.enemy_live
  wrapped = (enemy_x < -ENEMY_W) | (enemy_x > 160.0)
  enemy_x = torch.where(wrapped, c.enemy_entry, enemy_x)
  respawn = torch.clamp(state.enemy_respawn - 1, min=0)
  do_respawn = ~state.enemy_live & (respawn == 0)
  enemy_x = torch.where(do_respawn, c.enemy_entry, enemy_x)
  enemy_live = state.enemy_live | do_respawn

  # Divers drift the opposite way, slower; idle lanes respawn stochastically.
  diver_x = state.diver_x - lane_dirs * DIVER_SPEED * state.diver_live
  diver_off = (diver_x < -DIVER_W) | (diver_x > 160.0)
  diver_live = state.diver_live & ~diver_off
  do_diver = ~diver_live & (draws.spawn_u < DIVER_SPAWN_PROB)
  diver_x = torch.where(do_diver, c.diver_entry, diver_x)
  diver_live = diver_live | do_diver

  # Torpedo: one on screen; travels horizontally at launch height.
  do_fire = fire & ~state.torp_live & ~surfaced
  torp_x = torch.where(
      do_fire, player_x + torch.where(facing > 0, PLAYER_W, -TORPEDO_W),
      state.torp_x)
  torp_y = torch.where(do_fire, player_y + PLAYER_H / 2, state.torp_y)
  torp_dir = torch.where(do_fire, facing, state.torp_dir)
  torp_live = state.torp_live | do_fire
  torp_x = torp_x + torch.where(torp_live, torp_dir * TORPEDO_SPEED, 0.0)
  torp_live = torp_live & (torp_x > -TORPEDO_W) & (torp_x < 160.0)

  # Torpedo <-> enemy: same lane band + horizontal overlap.
  ty, tx = torp_y[:, None], torp_x[:, None]
  same_lane = (ty + TORPEDO_H >= lane_ys) & (ty <= lane_ys + ENEMY_H)
  overlap_x = (tx + TORPEDO_W >= enemy_x) & (tx <= enemy_x + ENEMY_W)
  hit = enemy_live & same_lane & overlap_x & torp_live[:, None]
  any_hit = hit.any(dim=1)
  enemy_live = enemy_live & ~hit
  respawn = torch.where(hit, ENEMY_RESPAWN_FRAMES, respawn)
  torp_live = torp_live & ~any_hit
  reward = reward + KILL_POINTS * hit.sum(dim=1).to(torch.float32)

  # Player <-> diver pickup (up to 6 held).
  py, px = player_y[:, None], player_x[:, None]
  p_band = (py + PLAYER_H >= lane_ys) & (py <= lane_ys + DIVER_H)
  p_over = (px + PLAYER_W >= diver_x) & (px <= diver_x + DIVER_W)
  grab = (diver_live & p_band & p_over
          & (state.divers_held < MAX_DIVERS)[:, None])
  diver_live = diver_live & ~grab
  divers_held = torch.clamp(
      state.divers_held + grab.sum(dim=1).to(torch.int32), max=MAX_DIVERS)

  # Player <-> enemy collision.
  e_band = (py + PLAYER_H >= lane_ys) & (py <= lane_ys + ENEMY_H)
  e_over = (px + PLAYER_W >= enemy_x) & (px <= enemy_x + ENEMY_W)
  vulnerable = state.invuln <= 0
  collided = ((enemy_live & e_band & e_over).any(dim=1) & vulnerable
              & ~surfaced)

  # Oxygen: depletes underwater, refills at the surface.
  oxygen = torch.where(
      surfaced,
      torch.clamp(state.oxygen + OXYGEN_REFILL_RATE, max=OXYGEN_MAX),
      state.oxygen - 1.0)
  suffocated = oxygen <= 0.0

  # Surfacing transition (underwater -> surface): with all 6 divers, cash
  # them in (+50 each) and advance the level; with 1..5, one diver
  # disembarks; with none, the trip costs a life (the ALE rule).
  just_surfaced = surfaced & ~state.was_surfaced
  cash_in = just_surfaced & (divers_held == MAX_DIVERS)
  drop_one = just_surfaced & (divers_held > 0) & ~cash_in
  bad_surface = just_surfaced & (divers_held == 0) & vulnerable
  reward = reward + torch.where(cash_in, DIVER_CASH_POINTS * MAX_DIVERS, 0.0)
  divers_held = torch.where(
      cash_in, 0, torch.where(drop_one, divers_held - 1, divers_held)).to(
          torch.int32)
  level = state.level + cash_in.to(torch.int32)

  life_lost_now = collided | suffocated | bad_surface
  lives = state.lives - life_lost_now.to(torch.int32)
  done = lives <= 0

  # Respawn after a hit: back to the surface spawn point with full air and
  # a short grace period.
  player_x = torch.where(life_lost_now, PLAYER_X0, player_x)
  player_y = torch.where(life_lost_now, PLAYER_Y0, player_y)
  oxygen = torch.where(life_lost_now, OXYGEN_MAX, oxygen)
  surfaced_next = surfaced | life_lost_now
  invuln = torch.where(life_lost_now, INVULN_FRAMES,
                       torch.clamp(state.invuln - 1, min=0)).to(torch.int32)
  torp_live = torp_live & ~life_lost_now

  new_state = SeaquestState(
      player_x, player_y, facing, torp_x, torp_y, torp_dir, torp_live,
      enemy_x, enemy_live, respawn.to(torch.int32), diver_x, diver_live,
      divers_held, oxygen, surfaced_next, lives, level, invuln)
  life_lost = life_lost_now & ~done
  return new_state, reward, done, life_lost


def seaquest_render(state: SeaquestState) -> torch.Tensor:
  b = state.player_x.shape[0]
  dev = state.player_x.device
  water = render.rect_mask(SKY_BOTTOM, 193, 0, 160, dev)
  floor = render.rect_mask(193, 210, 0, 160, dev)
  # A true division, as the reference's: CUDA turns a division by a host
  # scalar into a product with its reciprocal, which can move the bar's
  # integer end by a pixel.
  oxy_w = torch.div(60.0 * state.oxygen,
                    torch.full_like(state.oxygen, OXYGEN_MAX))
  oxy = render.rect_mask(198, 203, 49, 49.0 + oxy_w, dev)

  lane_masks = diver_masks = torch.zeros((b, 210, 160), dtype=torch.bool,
                                         device=dev)
  for i, ly in enumerate(LANE_YS):
    ex, dx = state.enemy_x[:, i], state.diver_x[:, i]
    e = render.rect_mask(int(ly), int(ly + ENEMY_H), ex, ex + ENEMY_W, dev)
    lane_masks = lane_masks | (e & state.enemy_live[:, i, None, None])
    d = render.rect_mask(int(ly), int(ly + DIVER_H), dx, dx + DIVER_W, dev)
    diver_masks = diver_masks | (d & state.diver_live[:, i, None, None])

  player = render.rect_mask(state.player_y, state.player_y + PLAYER_H,
                            state.player_x, state.player_x + PLAYER_W, dev)
  torp = render.rect_mask(state.torp_y, state.torp_y + TORPEDO_H,
                          state.torp_x, state.torp_x + TORPEDO_W, dev)
  torp = torp & state.torp_live[:, None, None]
  # Held-diver tally marks along the bottom.
  held = torch.zeros((b, 210, 160), dtype=torch.bool, device=dev)
  for i in range(MAX_DIVERS):
    m = render.rect_mask(198, 203, 120 + 6 * i, 124 + 6 * i, dev)
    held = held | (m & (state.divers_held > i)[:, None, None])

  return render.compose(
      b, dev,
      (45, 50, 184),  # sky
      (water, (24, 26, 167)),
      (floor, (158, 208, 101)),
      (oxy, (214, 214, 214)),
      (lane_masks, (92, 186, 92)),  # sharks
      (diver_masks, (66, 72, 200)),
      (held, (24, 59, 157)),
      (torp, (236, 236, 236)),
      (player, (187, 187, 53)),
  )


def seaquest_lives(state: SeaquestState) -> torch.Tensor:
  return state.lives


GAME = register_game(Game(
    name="seaquest",
    num_actions=18,
    init=seaquest_init,
    step=seaquest_step,
    render=seaquest_render,
    lives=seaquest_lives,
    init_draws=seaquest_init_draws,
    step_draws=seaquest_step_draws,
    per_frame_draws=True,
))
