"""Beam Rider, batched (port of dqn_zoo_tpu/envs/games/beam_rider.py).

Same constants, update order, float expressions and colours as the
reference: a ship hopping between 5 beams, saucers streaming down them (44
a kill, 15 kills clear a sector and speed the next), 3 torpedoes a sector
that clear the ship's beam (80 a saucer), 3 lives, 9 actions. The reference
splits a key carried in the state at init (the ship's beam) and on every raw
frame (a spawn test and a beam for each saucer slot); here the state carries
no key, `init` takes `BeamRiderInitDraws` and `step` takes
`BeamRiderStepDraws`, the draws of one raw frame. The game declares
`per_frame_draws`, so the vector env hands each frame of a group and of the
noop burn its own.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from dqn_zoo_torch.envs import render
from dqn_zoo_torch.envs.api import Game, register_game
from dqn_zoo_torch.envs.games import last_true

BEAMS = 5
BEAM_XS = (24.0, 52.0, 80.0, 108.0, 136.0)  # beam center columns
NUM_SAUCERS = 3
SAUCER_W, SAUCER_H = 12, 6
TOP_Y, SHIP_Y = 48.0, 180.0
SHIP_W, SHIP_H = 14, 8
SHOT_W, SHOT_SPEED = 2, 6.0
SAUCER_SPEED = 1.1
SPAWN_PROB = 0.025
LIVES = 3
HIT_PAUSE = 35
HOP_COOLDOWN = 8  # frames between beam hops (lane-locked movement)
SAUCER_POINTS = 44.0
KILLS_PER_SECTOR = 15
TORPEDOES_PER_SECTOR = 3
TORPEDO_POINTS = 80.0  # a torpedoed saucer pays more


class BeamRiderState(NamedTuple):
  ship_beam: torch.Tensor  # (B,) i32 in [0, BEAMS)
  hop_cd: torch.Tensor  # (B,) i32
  saucer_beam: torch.Tensor  # (B, N) i32
  saucer_y: torch.Tensor  # (B, N) f32
  saucer_live: torch.Tensor  # (B, N) bool
  shot_y: torch.Tensor  # (B,) f32
  shot_beam: torch.Tensor  # (B,) i32
  shot_live: torch.Tensor  # (B,) bool
  torpedoes: torch.Tensor  # (B,) i32 left this sector
  lives: torch.Tensor  # (B,) i32
  sector: torch.Tensor  # (B,) i32
  kills: torch.Tensor  # (B,) i32 kills this sector
  hit_pause: torch.Tensor  # (B,) i32


class BeamRiderInitDraws(NamedTuple):
  ship_beam: torch.Tensor  # (B,) int in [0, BEAMS)


class BeamRiderStepDraws(NamedTuple):
  spawn_u: torch.Tensor  # (B, N) U[0, 1): an idle slot spawns where < 0.025
  beam: torch.Tensor  # (B, N) int in [0, BEAMS), a spawn's beam


def beam_rider_init_draws(gen, b, device) -> BeamRiderInitDraws:
  return BeamRiderInitDraws(ship_beam=torch.randint(
      0, BEAMS, (b,), generator=gen, device=device, dtype=torch.int32))


def beam_rider_step_draws(gen, b, device, frames: int) -> BeamRiderStepDraws:
  """The saucer draws of `frames` raw frames: (frames, B, N) each."""
  shape = (frames, b, NUM_SAUCERS)
  return BeamRiderStepDraws(
      spawn_u=torch.rand(shape, generator=gen, device=device),
      beam=torch.randint(0, BEAMS, shape, generator=gen, device=device,
                         dtype=torch.int32))


def beam_rider_init(draws: BeamRiderInitDraws) -> BeamRiderState:
  b = draws.ship_beam.shape[0]
  dev = draws.ship_beam.device
  i = lambda v, *s: torch.full((b,) + s, v, dtype=torch.int32, device=dev)
  return BeamRiderState(
      ship_beam=draws.ship_beam.to(torch.int32),
      hop_cd=i(0),
      saucer_beam=i(0, NUM_SAUCERS),
      saucer_y=torch.zeros((b, NUM_SAUCERS), dtype=torch.float32,
                           device=dev),
      saucer_live=torch.zeros((b, NUM_SAUCERS), dtype=torch.bool,
                              device=dev),
      shot_y=torch.zeros((b,), dtype=torch.float32, device=dev),
      shot_beam=i(0),
      shot_live=torch.zeros((b,), dtype=torch.bool, device=dev),
      torpedoes=i(TORPEDOES_PER_SECTOR),
      lives=i(LIVES),
      sector=i(0),
      kills=i(0),
      hit_pause=i(0),
  )


class _Tables(NamedTuple):
  beam_x: torch.Tensor  # (BEAMS,) f32
  beams: torch.Tensor  # (210, 160) bool
  pips: torch.Tensor  # (TORPEDOES_PER_SECTOR, 210, 160) bool
  pip_ids: torch.Tensor  # (TORPEDOES_PER_SECTOR,) i32


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> _Tables:
  """The render's constant tensors on `device`, copied there once."""
  beams = torch.zeros((210, 160), dtype=torch.bool, device=device)
  for x in BEAM_XS:
    beams = beams | render.rect_mask(int(TOP_Y), 196, int(x - 1), int(x + 1),
                                     device)
  pips = torch.stack([render.rect_mask(36, 42, 8 + i * 8, 13 + i * 8, device)
                      for i in range(TORPEDOES_PER_SECTOR)])
  return _Tables(
      beam_x=torch.tensor(BEAM_XS, dtype=torch.float32, device=device),
      beams=beams, pips=pips,
      pip_ids=torch.arange(TORPEDOES_PER_SECTOR, dtype=torch.int32,
                           device=device))


def beam_rider_step(state: BeamRiderState, action: torch.Tensor,
                    draws: BeamRiderStepDraws):
  right = (action == 3) | (action == 5) | (action == 7)
  left = (action == 4) | (action == 6) | (action == 8)
  fire = (action == 1) | (action == 7) | (action == 8)
  torpedo = (action == 2) | (action == 5) | (action == 6)

  can_hop = state.hop_cd <= 0
  hop_cd = torch.clamp(state.hop_cd - 1, min=0)
  d = right.to(torch.int32) - left.to(torch.int32)
  ship_beam = torch.clamp(state.ship_beam + torch.where(can_hop, d, 0),
                          0, BEAMS - 1).to(torch.int32)
  hopped = ship_beam != state.ship_beam
  hop_cd = torch.where(hopped, HOP_COOLDOWN, hop_cd)

  # Saucers stream down; idle slots spawn on random beams.
  speed = SAUCER_SPEED + 0.25 * state.sector.to(torch.float32)
  saucer_y = state.saucer_y + torch.where(state.saucer_live, speed[:, None],
                                          0.0)
  spawn = ~state.saucer_live & (draws.spawn_u < SPAWN_PROB)
  saucer_beam = torch.where(spawn, draws.beam.to(torch.int32),
                            state.saucer_beam)
  saucer_y = torch.where(spawn, TOP_Y, saucer_y)
  saucer_live = state.saucer_live | spawn
  # A saucer that reaches the bottom leaves (no penalty).
  saucer_live = saucer_live & (saucer_y < 200.0)

  # Laser shot: one in flight, up the beam it was fired on.
  zero = torch.zeros_like(state.shot_y)
  do_fire = fire & ~state.shot_live
  shot_beam = torch.where(do_fire, ship_beam, state.shot_beam)
  shot_y = torch.where(do_fire, SHIP_Y - 2.0, state.shot_y)
  shot_live = state.shot_live | do_fire
  shot_y = shot_y - torch.where(shot_live, SHOT_SPEED, zero)
  shot_live = shot_live & (shot_y > TOP_Y - 4.0)

  sy = shot_y[:, None]
  hit = (shot_live[:, None] & saucer_live
         & (saucer_beam == shot_beam[:, None])
         & (sy <= saucer_y + SAUCER_H) & (sy + 6.0 >= saucer_y))
  # One shot kills one saucer: the last hit slot.
  kill = last_true(hit)
  any_hit = hit.any(dim=1)
  shot_live = shot_live & ~any_hit
  reward = torch.where(any_hit, SAUCER_POINTS, zero)

  # Torpedo: clears every saucer on the ship's beam at once.
  do_torp = torpedo & (state.torpedoes > 0)
  torp_kill = (do_torp[:, None] & saucer_live
               & (saucer_beam == ship_beam[:, None]))
  torpedoes = state.torpedoes - do_torp.to(torch.int32)
  reward = reward + TORPEDO_POINTS * torp_kill.sum(
      dim=1, dtype=torch.int32).to(torch.float32)
  killed = kill | torp_kill
  saucer_live = saucer_live & ~killed
  kills = state.kills + killed.sum(dim=1, dtype=torch.int32)

  # A saucer reaching the ship's row on its beam: a collision.
  vulnerable = state.hit_pause <= 0
  hit_pause = torch.clamp(state.hit_pause - 1, min=0)
  contact = (saucer_live & (saucer_beam == ship_beam[:, None])
             & (saucer_y + SAUCER_H >= SHIP_Y))
  crashed = contact.any(dim=1) & vulnerable
  saucer_live = saucer_live & ~contact
  lives = state.lives - crashed.to(torch.int32)
  hit_pause = torch.where(crashed, HIT_PAUSE, hit_pause)

  # Sector clear: faster saucers, fresh torpedoes.
  next_sector = kills >= KILLS_PER_SECTOR
  sector = state.sector + next_sector.to(torch.int32)
  kills = torch.where(next_sector, 0, kills)
  torpedoes = torch.where(next_sector, TORPEDOES_PER_SECTOR, torpedoes)

  done = lives <= 0
  new_state = BeamRiderState(
      ship_beam, hop_cd, saucer_beam, saucer_y, saucer_live, shot_y,
      shot_beam, shot_live, torpedoes, lives, sector, kills, hit_pause)
  life_lost = crashed & ~done
  return new_state, reward, done, life_lost


def beam_rider_render(state: BeamRiderState) -> torch.Tensor:
  b = state.shot_y.shape[0]
  dev = state.shot_y.device
  c = _tables(dev)
  rect = lambda *box: render.rect_mask(*box, dev)
  bx = c.beam_x
  saucers = torch.zeros((b, 210, 160), dtype=torch.bool, device=dev)
  for i in range(NUM_SAUCERS):
    x = bx[state.saucer_beam[:, i].long()]
    y = state.saucer_y[:, i]
    s = rect(y, y + SAUCER_H, x - SAUCER_W / 2, x + SAUCER_W / 2)
    saucers = saucers | (s & state.saucer_live[:, i, None, None])
  sx = bx[state.shot_beam.long()]
  shot = rect(state.shot_y, state.shot_y + 6, sx - SHOT_W / 2,
              sx + SHOT_W / 2) & state.shot_live[:, None, None]
  shipx = bx[state.ship_beam.long()]
  ship = rect(int(SHIP_Y), int(SHIP_Y) + SHIP_H, shipx - SHIP_W / 2,
              shipx + SHIP_W / 2)
  # Torpedo pips (visible state, top left).
  pips = (c.pips & (state.torpedoes[:, None] > c.pip_ids)[:, :, None, None]
          ).any(dim=1)
  return render.compose(
      b, dev, (0, 0, 12),
      (c.beams, (48, 60, 110)),
      (saucers, (220, 220, 220)),
      (shot, (250, 250, 120)),
      (ship, (90, 186, 220)),
      (pips, (250, 160, 60)),
  )


def beam_rider_lives(state: BeamRiderState) -> torch.Tensor:
  return state.lives


GAME = register_game(Game(
    name="beam_rider",
    num_actions=9,
    init=beam_rider_init,
    step=beam_rider_step,
    render=beam_rider_render,
    lives=beam_rider_lives,
    init_draws=beam_rider_init_draws,
    step_draws=beam_rider_step_draws,
    per_frame_draws=True,
))
