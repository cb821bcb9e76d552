"""Atlantis, batched (port of dqn_zoo_tpu/envs/games/atlantis.py).

Same constants, update order, float expressions and colours as the
reference: three fixed guns (left, centre, right; 4 actions) shoot Gorgon
ships crossing four altitude bands; a ship that finishes a pass drops a
band, and from the lowest one its death ray destroys a city installation;
the game ends with the sixth (no lives). The reference splits a key carried
in the state at init (the ships' directions) and on every raw frame (a spawn
test and a direction for each band); here the state carries no key, `init`
takes `AtlantisInitDraws` and `step` takes `AtlantisStepDraws`, the draws of
one raw frame. The game declares `per_frame_draws`, so the vector env hands
each frame of a group and of the noop burn its own. The centre gun's test
takes the ship's x as XLA compiles the reference's, `(sx + 6) - 80` folded
into `sx - 74`.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from dqn_zoo_torch.envs import render
from dqn_zoo_torch.envs.api import Game, register_game

NUM_BANDS = 4
BAND_TOP = 40
BAND_H = 18
SHIP_W, SHIP_H = 12, 6
BAND_SPEEDS = (0.8, 1.2, 1.7, 2.3)  # px/frame, lowest band first
NUM_CITY = 6
CITY_Y = 180
CITY_W, CITY_H = 14, 14
CITY_XS = tuple(14 + i * 24 for i in range(NUM_CITY))  # left edges
CENTER_GUN_X = 80.0
SIDE_L_X, SIDE_R_X = 20.0, 140.0
GUN_Y = 176.0
FIRE_COOLDOWN = 8  # frames between shots per gun
SPAWN_PROB = 0.04
BEAM_HALF_W = 5.0  # hitscan tolerance


class AtlantisState(NamedTuple):
  ship_x: torch.Tensor  # (B, NUM_BANDS) f32, left edge
  ship_live: torch.Tensor  # (B, NUM_BANDS) bool
  ship_dir: torch.Tensor  # (B, NUM_BANDS) f32 ±1
  ship_band: torch.Tensor  # (B, NUM_BANDS) i32, altitude band (0 lowest)
  city_live: torch.Tensor  # (B, NUM_CITY) bool
  cooldown: torch.Tensor  # (B, 3) i32, frames until each gun (L, C, R) fires
  flash: torch.Tensor  # (B, 3) i32, frames each beam is still drawn


class AtlantisInitDraws(NamedTuple):
  right: torch.Tensor  # (B, NUM_BANDS) bool — a slot starts moving right


class AtlantisStepDraws(NamedTuple):
  spawn_u: torch.Tensor  # (B, NUM_BANDS) U[0, 1): a dead slot spawns < 0.04
  right: torch.Tensor  # (B, NUM_BANDS) bool — a spawn moves right


def atlantis_init_draws(gen, b, device) -> AtlantisInitDraws:
  return AtlantisInitDraws(
      right=torch.rand((b, NUM_BANDS), generator=gen, device=device) < 0.5)


def atlantis_step_draws(gen, b, device, frames: int) -> AtlantisStepDraws:
  """The slot draws of `frames` raw frames: (frames, B, NUM_BANDS) each."""
  shape = (frames, b, NUM_BANDS)
  return AtlantisStepDraws(
      spawn_u=torch.rand(shape, generator=gen, device=device),
      right=torch.rand(shape, generator=gen, device=device) < 0.5)


def _sign(right: torch.Tensor) -> torch.Tensor:
  return torch.where(right, 1.0, -1.0).to(torch.float32)


def atlantis_init(draws: AtlantisInitDraws) -> AtlantisState:
  b = draws.right.shape[0]
  dev = draws.right.device
  return AtlantisState(
      ship_x=torch.zeros((b, NUM_BANDS), dtype=torch.float32, device=dev),
      ship_live=torch.zeros((b, NUM_BANDS), dtype=torch.bool, device=dev),
      ship_dir=_sign(draws.right),
      ship_band=torch.arange(NUM_BANDS, dtype=torch.int32,
                             device=dev).repeat(b, 1),
      city_live=torch.ones((b, NUM_CITY), dtype=torch.bool, device=dev),
      cooldown=torch.zeros((b, 3), dtype=torch.int32, device=dev),
      flash=torch.zeros((b, 3), dtype=torch.int32, device=dev),
  )


class _Tables(NamedTuple):
  band_speeds: torch.Tensor  # (NUM_BANDS,) f32
  slot_band: torch.Tensor  # (1, NUM_BANDS) i32, a slot's spawn band
  sea: torch.Tensor  # (210, 160) bool
  city: torch.Tensor  # (NUM_CITY, 210, 160) bool
  guns: torch.Tensor  # (210, 160) bool
  beams: torch.Tensor  # (3, 210, 160) bool, the L, C and R beam cues


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> _Tables:
  """The step's and the render's constant tensors on `device`, copied there
  once."""
  mask = lambda *box: render.rect_mask(*box, device)
  guns = torch.zeros((210, 160), dtype=torch.bool, device=device)
  for gx in (SIDE_L_X, CENTER_GUN_X, SIDE_R_X):
    guns = guns | mask(int(GUN_Y), int(GUN_Y) + 6, int(gx) - 3, int(gx) + 3)
  # Beam cues: a vertical strip for the centre gun, 45° strips for the
  # side guns.
  rows = torch.arange(210, dtype=torch.float32, device=device)[:, None]
  cols = torch.arange(160, dtype=torch.float32, device=device)[None, :]
  above = rows < GUN_Y
  diag_l = (torch.abs((cols - SIDE_L_X) - (GUN_Y - rows)) < 1.5) & above
  diag_r = (torch.abs((SIDE_R_X - cols) - (GUN_Y - rows)) < 1.5) & above
  centre = mask(30, int(GUN_Y), int(CENTER_GUN_X) - 1, int(CENTER_GUN_X) + 1)
  return _Tables(
      band_speeds=torch.tensor(BAND_SPEEDS, dtype=torch.float32,
                               device=device),
      slot_band=torch.arange(NUM_BANDS, dtype=torch.int32,
                             device=device)[None, :],
      sea=mask(196, 210, 0, 160),
      city=torch.stack([mask(CITY_Y, CITY_Y + CITY_H, x, x + CITY_W)
                        for x in CITY_XS]),
      guns=guns, beams=torch.stack([diag_l, centre, diag_r]))


def _band_y(band: torch.Tensor) -> torch.Tensor:
  """Band index (0 = lowest) -> ship top y."""
  return (BAND_TOP + (NUM_BANDS - 1 - band).to(torch.float32) * BAND_H
          + (BAND_H - SHIP_H) / 2.0)


def atlantis_step(state: AtlantisState, action: torch.Tensor,
                  draws: AtlantisStepDraws):
  c = _tables(state.ship_x.device)
  # ALE's minimal set: 0 NOOP, 1 FIRE (centre), 2 RIGHTFIRE, 3 LEFTFIRE.
  fire = torch.stack([action == 3, action == 1, action == 2], dim=1)

  # Ship motion.
  speeds = c.band_speeds[state.ship_band.long()]
  sx = state.ship_x + state.ship_dir * speeds
  cy = _band_y(state.ship_band) + SHIP_H / 2.0

  # Firing: each ready gun downs every live ship on its beam line (within
  # BEAM_HALF_W of the ship's centre). Centre gun: x = CENTER_GUN_X; the
  # side guns: 45° up from (SIDE_L_X, GUN_Y) and (SIDE_R_X, GUN_Y).
  ready = fire & (state.cooldown <= 0)
  cx = sx + SHIP_W / 2.0
  reach = BEAM_HALF_W + SHIP_W / 2
  on_beam = (
      torch.abs(cx - (SIDE_L_X + (GUN_Y - cy))) <= reach,
      torch.abs(sx + (SHIP_W / 2.0 - CENTER_GUN_X)) <= reach,
      torch.abs(cx - (SIDE_R_X - (GUN_Y - cy))) <= reach)
  ship_hit = torch.zeros_like(state.ship_live)
  for g in range(3):
    ship_hit = ship_hit | (on_beam[g] & state.ship_live & ready[:, g, None])
  # Score by altitude band: 100·(band+1).
  reward = torch.where(
      ship_hit, 100.0 * (state.ship_band.to(torch.float32) + 1),
      0.0).sum(dim=1)
  live = state.ship_live & ~ship_hit
  cooldown = torch.where(ready, FIRE_COOLDOWN,
                         torch.clamp(state.cooldown - 1, min=0))
  flash = torch.where(ready, 3, torch.clamp(state.flash - 1, min=0))

  # A ship finishing its pass drops one band; from band 0 it fires the death
  # ray: the first live city dies and the ship leaves.
  off = (sx < -float(SHIP_W)) | (sx > 160.0)
  finishing = live & off
  at_bottom = finishing & (state.ship_band == 0)
  band = torch.where(finishing, torch.clamp(state.ship_band - 1, min=0),
                     state.ship_band)
  ray = at_bottom.any(dim=1)
  first_live = state.city_live & (torch.cumsum(state.city_live, dim=1) == 1)
  city_live = state.city_live & ~(first_live & ray[:, None])
  live = live & ~at_bottom
  # Finishing ships above band 0 re-enter on the other side, one band lower.
  reenter = finishing & ~at_bottom
  sx = torch.where(reenter, torch.where(state.ship_dir > 0,
                                        -float(SHIP_W) + 1.0, 159.0), sx)

  # Spawns: a dead slot enters at its own band.
  do_spawn = ~live & (draws.spawn_u < SPAWN_PROB)
  dirs = torch.where(do_spawn, _sign(draws.right), state.ship_dir)
  band = torch.where(do_spawn, c.slot_band, band).to(torch.int32)
  sx = torch.where(do_spawn, torch.where(dirs > 0, -float(SHIP_W) + 1.0,
                                         159.0), sx)
  live = live | do_spawn

  done = ~city_live.any(dim=1)
  new_state = AtlantisState(sx, live, dirs, band, city_live,
                            cooldown.to(torch.int32), flash.to(torch.int32))
  return new_state, reward, done, torch.zeros_like(done)


def atlantis_render(state: AtlantisState) -> torch.Tensor:
  b = state.ship_x.shape[0]
  dev = state.ship_x.device
  c = _tables(dev)
  city = (c.city[None] & state.city_live[:, :, None, None]).any(dim=1)
  beams = (c.beams[None] & (state.flash > 0)[:, :, None, None]).any(dim=1)
  ships = torch.zeros((b, 210, 160), dtype=torch.bool, device=dev)
  y = _band_y(state.ship_band)
  for i in range(NUM_BANDS):
    s = render.rect_mask(y[:, i], y[:, i] + SHIP_H, state.ship_x[:, i],
                         state.ship_x[:, i] + SHIP_W, dev)
    ships = ships | (s & state.ship_live[:, i, None, None])
  return render.compose(b, dev, (12, 12, 40),
                        (c.sea, (26, 72, 118)),
                        (city, (200, 170, 80)),
                        (c.guns, (180, 180, 180)),
                        (beams, (236, 236, 120)),
                        (ships, (170, 80, 170)))


def atlantis_lives(state: AtlantisState) -> torch.Tensor:
  return torch.ones_like(state.cooldown[:, 0])


GAME = register_game(Game(
    name="atlantis",
    num_actions=4,
    init=atlantis_init,
    step=atlantis_step,
    render=atlantis_render,
    lives=atlantis_lives,
    init_draws=atlantis_init_draws,
    step_draws=atlantis_step_draws,
    per_frame_draws=True,
))
