"""Ice Hockey, batched (port of dqn_zoo_tpu/envs/games/ice_hockey.py).

Same constants, update order, float expressions and colours as the
reference: one skater each side on a rink with a game clock, a loose puck
sticks to the skater it touches, the player shoots on FIRE and the enemy on
a timer, both aiming across a band wider than the goal mouth, +1 a goal
into the top net and -1 a goal into the bottom one, no lives, 12,000-frame
episodes, the 18 joystick actions. The reference splits a key carried in
the state at init (the puck's first row) and on every raw frame (the aim,
the enemy's shot test); here the state carries no key, `init` takes
`IceHockeyInitDraws` and `step` takes `IceHockeyStepDraws`, the draws of
one raw frame. The game declares `per_frame_draws`, so the vector env hands
each frame of a group and of the noop burn its own.

XLA folds the enemy's `y + P_H + CARRY_OFF` and `y + P_H + 2` into
`y + 14`; the port writes the folded sums. The shots divide by
state-dependent values, which XLA keeps as true divisions.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from dqn_zoo_torch.envs import render
from dqn_zoo_torch.envs.api import Game, register_game
from dqn_zoo_torch.envs.games import joystick

TOP, BOTTOM = 40.0, 190.0
LEFT, RIGHT = 12.0, 148.0
GOAL_X0, GOAL_X1 = 62.0, 98.0  # goal mouths (top and bottom walls)
P_W, P_H = 8, 12
PLAYER_SPEED = 2.2
ENEMY_SPEED = 1.8
PUCK = 3
SHOT_SPEED = 4.5
CLOCK_FRAMES = 12000  # the cartridge's timed periods
CARRY_OFF = 2.0  # the puck rides this far in front of its carrier
ENEMY_SHOT_PROB = 0.0028  # a carrying enemy shoots with this, a frame
FRICTION = 0.985
AIM_LOW, AIM_HIGH = GOAL_X0 - 10.0, GOAL_X1 + 10.0 - PUCK
MID = (TOP + BOTTOM) / 2


class IceHockeyState(NamedTuple):
  px: torch.Tensor  # (B,) f32 player left edge
  py: torch.Tensor  # (B,) f32
  ex: torch.Tensor  # (B,) f32 enemy
  ey: torch.Tensor  # (B,) f32
  puck_x: torch.Tensor  # (B,) f32
  puck_y: torch.Tensor  # (B,) f32
  puck_vx: torch.Tensor  # (B,) f32
  puck_vy: torch.Tensor  # (B,) f32
  carrier: torch.Tensor  # (B,) i32: 0 loose, 1 player, 2 enemy
  frame: torch.Tensor  # (B,) i32 game clock
  faceoff_delay: torch.Tensor  # (B,) i32 frames to a live puck after a goal


class IceHockeyInitDraws(NamedTuple):
  puck_y: torch.Tensor  # (B,) f32 in [100, 120)


class IceHockeyStepDraws(NamedTuple):
  aim: torch.Tensor  # (B,) f32 in [AIM_LOW, AIM_HIGH), a shot's target x
  shot_u: torch.Tensor  # (B,) U[0, 1): a carrying enemy shoots < 0.0028


def ice_hockey_init_draws(gen, b, device) -> IceHockeyInitDraws:
  u = torch.rand((b,), generator=gen, device=device)
  return IceHockeyInitDraws(puck_y=u * 20.0 + 100.0)


def ice_hockey_step_draws(gen, b, device, frames: int) -> IceHockeyStepDraws:
  """The aims and shot tests of `frames` raw frames: (frames, B) each."""
  u = torch.rand((frames, b), generator=gen, device=device)
  return IceHockeyStepDraws(
      aim=u * (AIM_HIGH - AIM_LOW) + AIM_LOW,
      shot_u=torch.rand((frames, b), generator=gen, device=device))


def ice_hockey_init(draws: IceHockeyInitDraws) -> IceHockeyState:
  b = draws.puck_y.shape[0]
  dev = draws.puck_y.device
  f = lambda v: torch.full((b,), v, dtype=torch.float32, device=dev)
  i = lambda: torch.zeros((b,), dtype=torch.int32, device=dev)
  return IceHockeyState(
      px=f(76.0), py=f(150.0), ex=f(76.0), ey=f(66.0), puck_x=f(78.0),
      puck_y=draws.puck_y.to(torch.float32), puck_vx=f(0.0),
      puck_vy=f(0.0), carrier=i(), frame=i(), faceoff_delay=i())


def ice_hockey_step(state: IceHockeyState, action: torch.Tensor,
                    draws: IceHockeyStepDraws):
  dx, dy, fire = joystick(action)
  px = torch.clamp(state.px + dx * PLAYER_SPEED, LEFT, RIGHT - P_W)
  py = torch.clamp(state.py + dy * PLAYER_SPEED, MID, BOTTOM - P_H)

  # The enemy chases the puck in the upper half, and falls back to its
  # goal mouth while the player carries.
  carried_p = state.carrier == 1
  carried_e = state.carrier == 2
  target_x = torch.where(carried_p, (GOAL_X0 + GOAL_X1) / 2 - P_W / 2,
                         state.puck_x - P_W / 2)
  target_y = torch.where(carried_p, TOP + 8.0,
                         torch.clamp(state.puck_y, max=MID - P_H))
  ex = state.ex + torch.clamp(target_x - state.ex, -ENEMY_SPEED, ENEMY_SPEED)
  ey = state.ey + torch.clamp(target_y - state.ey, -ENEMY_SPEED, ENEMY_SPEED)
  ex = torch.clamp(ex, LEFT, RIGHT - P_W)
  ey = torch.clamp(ey, TOP, MID - P_H)

  faceoff = torch.clamp(state.faceoff_delay - 1, min=0)
  live = faceoff == 0

  # The puck moves, or rides its carrier.
  puck_x = torch.where(carried_p, px + P_W / 2,
                       torch.where(carried_e, ex + P_W / 2, state.puck_x))
  puck_y = torch.where(carried_p, py - CARRY_OFF,
                       torch.where(carried_e, ey + (P_H + CARRY_OFF),
                                   state.puck_y))
  zero = torch.zeros_like(state.puck_vx)
  puck_vx = torch.where(state.carrier > 0, zero, state.puck_vx)
  puck_vy = torch.where(state.carrier > 0, zero, state.puck_vy)
  puck_x = puck_x + puck_vx * live
  puck_y = puck_y + puck_vy * live
  # Bounces off the boards (the goal mouths below), then friction.
  bounce_x = (puck_x < LEFT) | (puck_x > RIGHT - PUCK)
  puck_vx = torch.where(bounce_x, -puck_vx, puck_vx) * FRICTION
  puck_x = torch.clamp(puck_x, LEFT, RIGHT - PUCK)
  in_mouth = (puck_x >= GOAL_X0) & (puck_x + PUCK <= GOAL_X1)
  bounce_y = ((puck_y < TOP) | (puck_y > BOTTOM - PUCK)) & ~in_mouth
  puck_vy = torch.where(bounce_y, -puck_vy, puck_vy) * FRICTION
  puck_y = torch.where(in_mouth, puck_y,
                       torch.clamp(puck_y, TOP, BOTTOM - PUCK))

  # A loose puck touching a skater sticks to them.
  loose = live & (state.carrier == 0)
  touch_p = (loose & (puck_x + PUCK >= px) & (puck_x <= px + P_W)
             & (puck_y + PUCK >= py) & (puck_y <= py + P_H))
  touch_e = (loose & ~touch_p
             & (puck_x + PUCK >= ex) & (puck_x <= ex + P_W)
             & (puck_y + PUCK >= ey) & (puck_y <= ey + P_H))
  carrier = torch.where(touch_p, 1, torch.where(touch_e, 2, state.carrier))

  # Overlapping skaters hand the puck to the defender.
  overlap = ((px + P_W >= ex) & (px <= ex + P_W)
             & (py <= ey + (P_H + 2)) & (py + P_H >= ey - 2))
  carrier = torch.where(overlap & (carrier == 2), 1, carrier)

  # Shots: the player's toward the top mouth on FIRE, the enemy's toward
  # the bottom one on a timer, both at a drawn aim.
  aim = draws.aim.to(torch.float32)
  p_shoot = (carrier == 1) & fire
  dxs = (aim - puck_x) / torch.clamp(puck_y - TOP, min=1.0)
  puck_vx = torch.where(p_shoot, torch.clamp(dxs * SHOT_SPEED, -3.0, 3.0),
                        puck_vx)
  puck_vy = torch.where(p_shoot, -SHOT_SPEED, puck_vy)
  e_shoot = (carrier == 2) & (draws.shot_u < ENEMY_SHOT_PROB)
  dxe = (aim - puck_x) / torch.clamp(BOTTOM - puck_y, min=1.0)
  puck_vx = torch.where(e_shoot, torch.clamp(dxe * SHOT_SPEED, -3.0, 3.0),
                        puck_vx)
  puck_vy = torch.where(e_shoot, SHOT_SPEED, puck_vy)
  carrier = torch.where(p_shoot | e_shoot, 0, carrier)

  # A puck through a goal mouth scores; a faceoff at the centre follows.
  player_goal = (puck_y <= TOP - 1.0) & in_mouth
  enemy_goal = (puck_y >= BOTTOM - PUCK + 1.0) & in_mouth
  reward = player_goal.to(torch.float32) - enemy_goal.to(torch.float32)
  scored = player_goal | enemy_goal
  puck_x = torch.where(scored, 78.0, puck_x)
  puck_y = torch.where(scored, 114.0, puck_y)
  puck_vx = torch.where(scored, zero, puck_vx)
  puck_vy = torch.where(scored, zero, puck_vy)
  carrier = torch.where(scored, 0, carrier).to(torch.int32)
  faceoff = torch.where(scored, 90, faceoff)

  frame = state.frame + 1
  done = frame >= CLOCK_FRAMES
  new_state = IceHockeyState(px, py, ex, ey, puck_x, puck_y, puck_vx,
                             puck_vy, carrier, frame, faceoff)
  return new_state, reward, done, torch.zeros_like(done)


@functools.lru_cache(maxsize=None)
def _scenery(device: torch.device) -> tuple:
  """The rink's (mask, rgb) layers on `device`, made there once."""
  mask = lambda *box: render.rect_mask(*box, device)
  return ((mask(int(TOP), int(BOTTOM), int(LEFT), int(RIGHT)),
           (214, 214, 214)),
          (mask(int(MID - 1), int(MID + 1), int(LEFT), int(RIGHT)),
           (120, 128, 160)),
          (mask(int(TOP - 6), int(TOP), int(GOAL_X0), int(GOAL_X1)),
           (180, 60, 60)),
          (mask(int(BOTTOM), int(BOTTOM + 6), int(GOAL_X0), int(GOAL_X1)),
           (60, 60, 180)))


def ice_hockey_render(state: IceHockeyState) -> torch.Tensor:
  b = state.px.shape[0]
  dev = state.px.device
  rect = lambda *box: render.rect_mask(*box, dev)
  enemy = rect(state.ey, state.ey + P_H, state.ex, state.ex + P_W)
  player = rect(state.py, state.py + P_H, state.px, state.px + P_W)
  puck = rect(state.puck_y, state.puck_y + PUCK, state.puck_x,
              state.puck_x + PUCK)
  return render.compose(
      b, dev, (14, 22, 48), *_scenery(dev),
      (enemy, (200, 72, 72)),
      (player, (66, 114, 194)),
      (puck, (20, 20, 20)),
  )


def ice_hockey_lives(state: IceHockeyState) -> torch.Tensor:
  return torch.ones_like(state.frame)


GAME = register_game(Game(
    name="ice_hockey",
    num_actions=18,
    init=ice_hockey_init,
    step=ice_hockey_step,
    render=ice_hockey_render,
    lives=ice_hockey_lives,
    init_draws=ice_hockey_init_draws,
    step_draws=ice_hockey_step_draws,
    per_frame_draws=True,
))
