"""Differential tests of the port's enduro, gopher and ice_hockey against the
JAX package's (CPU): the vector env step for step over auto-resets, every
output and every state field exact, frames included; one raw frame on
hand-made states at the edges of the games' tests; enduro's render on cars
placed where XLA's compiled forms and the source's plain ones draw
different boxes; a JAX state taken in mid-episode and converted; and the
games' rules on the port's games.

Enduro splits its key in three on every raw frame (a respawn distance and
lane for each car) and again inside its init; gopher splits in three and
reads one coin, for both of its restarts; ice_hockey splits in three (the
aim and the enemy's shot test). JAX's draws come from its key chain
(tests/torch_games_jax.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_games_jax import converted_mid_episode, near, one_env, one_frame
from torch_games_jax import random_policy, render_sweep, run_against_jax
from torch_games_jax import step_sweep

from dqn_zoo_torch.envs.games import enduro as en
from dqn_zoo_torch.envs.games import gopher as go
from dqn_zoo_torch.envs.games import ice_hockey as ih
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

f32 = np.float32
GAMES = ["enduro", "gopher", "ice_hockey"]


def _enduro_end(gs):
  # Half the envs near the end of the clock, the others at full speed
  # with every car just ahead in the left lane (overtaken cleanly).
  b = gs.frame.shape[0]
  h = b // 2
  return gs._replace(
      frame=gs.frame.at[:h].set(en.EPISODE_FRAMES - 40),
      speed=gs.speed.at[h:].set(en.MAX_SPEED),
      car_z=gs.car_z.at[h:].set(5.0), car_lane=gs.car_lane.at[h:].set(0))


def _gopher_end(gs):
  # Half the envs near the end of the clock, the others with every hole
  # dug (a shovel fills one) and the gopher popped up under the farmer.
  b = gs.frame.shape[0]
  h = b // 2
  return gs._replace(
      frame=gs.frame.at[:h].set(go.EPISODE_FRAMES - 40),
      holes=gs.holes.at[h:].set(1), popped=gs.popped.at[h:].set(30),
      gcell=gs.gcell.at[h:].set(8))


def _hockey_end(gs):
  # Half the envs near the end of the clock, the others with a loose puck
  # sliding into the top goal mouth.
  b = gs.frame.shape[0]
  h = b // 2
  return gs._replace(
      frame=gs.frame.at[:h].set(ih.CLOCK_FRAMES - 40),
      puck_x=gs.puck_x.at[h:].set(78.0), puck_y=gs.puck_y.at[h:].set(50.0),
      puck_vx=gs.puck_vx.at[h:].set(0.0),
      puck_vy=gs.puck_vy.at[h:].set(-ih.SHOT_SPEED),
      carrier=gs.carrier.at[h:].set(0),
      ex=gs.ex.at[h:].set(ih.LEFT), ey=gs.ey.at[h:].set(90.0))


_PREPARE = {"enduro": _enduro_end, "gopher": _gopher_end,
            "ice_hockey": _hockey_end}


@pytest.mark.parametrize("name", GAMES)
def test_vector_env_matches_jax_step_for_step(name):
  b = 8
  seen = dict(rewards=0, game_overs=0)

  def count(before, after, out):
    seen["rewards"] += int(((out.raw_reward_sum != 0) & ~out.is_first).sum())
    seen["game_overs"] += int((out.is_last & ~out.is_truncated).sum())

  firsts = run_against_jax(name, b, 30, random_policy(name, b),
                           prepare=_PREPARE[name], on_step=count)
  assert firsts > b  # auto-resets after the first groups
  assert all(v > 0 for v in seen.values()), seen


@pytest.mark.parametrize("name", GAMES)
def test_converted_mid_episode_state_renders_and_steps_as_jax(name):
  jstate = converted_mid_episode(name, b=8)  # the step compiled above
  assert bool((np.asarray(jstate.episode_frames) > 100).all())


# --- enduro -------------------------------------------------------------------


def _car(z, lane):
  # Car 0 alone on the road, the others behind the player (not drawn).
  z = [z] + [-100.0] * (en.NUM_CARS - 1)
  return dict(car_z=z, car_lane=[lane] + [0] * (en.NUM_CARS - 1))


_NO_RESPAWN = dict(new_z=[300.0] * en.NUM_CARS,
                   new_lane=[0] * en.NUM_CARS)


def test_enduro_overtakes_pay_and_collisions_stop_the_car():
  # At full speed a car in the left lane just ahead is overtaken: +1.
  state = one_env(en, speed=en.MAX_SPEED, **_car(2.5, 0))
  s2, reward, _, _ = one_frame(en, state, 0, **_NO_RESPAWN)
  assert float(reward) == 1.0 and int(s2.passed) == 1
  # Crawling, a car just behind comes back past: -1.
  state = one_env(en, speed=0.0, **_car(-0.5, 0))
  s2, reward, _, _ = one_frame(en, state, 0, **_NO_RESPAWN)
  assert float(reward) == -1.0 and int(s2.passed) == -1
  # The same car in the player's lane is a collision: no point, a crawl,
  # and the car shoved ahead.
  state = one_env(en, speed=en.MAX_SPEED, **_car(2.5, 1))
  s2, reward, done, life_lost = one_frame(en, state, 1, **_NO_RESPAWN)
  assert float(reward) == 0.0 and float(s2.speed) == f32(en.CRASH_SPEED)
  assert float(s2.car_z[0, 0]) == 12.0
  assert not bool(done) and not bool(life_lost)


def test_enduro_far_behind_cars_respawn_and_the_clock_ends_it():
  state = one_env(en, frame=en.EPISODE_FRAMES - 1, speed=en.MAX_SPEED,
                  **_car(-59.0, 0))
  s2, _, done, _ = one_frame(en, state, 0, new_z=[321.5] * en.NUM_CARS,
                             new_lane=[2] * en.NUM_CARS)
  assert float(s2.car_z[0, 0]) == 321.5 and int(s2.car_lane[0, 0]) == 2
  assert bool(done)


def _mad(a, b, c, rounded):
  """a * b + c in f32: the product rounded first where `rounded`, else
  rounded once with the sum (a multiply-add)."""
  if rounded:
    return (f32(a) * f32(b)).astype(f32) + f32(c)
  return (np.float64(f32(a)) * np.float64(f32(b))
          + np.float64(f32(c))).astype(f32)


def _enduro_box(z, lane, flip=None):
  """The rows and columns (top, bottom, left, right) of a car's box at
  distance z in the lane centred at `lane`, as XLA compiles the reference's
  render: a product with 0.0025f, the square root correctly rounded, each
  product that feeds one sum fused into it, the half-width (it feeds two)
  rounded. `flip` names one form computed the other way: "recip" a true
  division by 400, "edges" the half-width fused into both edges, the
  others their sum with the product rounded first."""
  t = np.clip(z, 0, en.SPAWN_AHEAD).astype(f32)
  t = (t / f32(400.0) if flip == "recip" else t * f32(0.0025)).astype(f32)
  s = np.sqrt(t.astype(np.float64)).astype(f32)
  y = _mad(s, -102.0, 160.0, flip == "y")
  scale = _mad(s, -0.7, 1.0, flip == "scale")
  pinch = _mad(s, -0.6, 1.0, flip == "pinch")
  x = _mad(np.full_like(s, lane - 80.0), pinch, 80.0, flip == "x")
  top = _mad(scale, -10.0, y, flip == "top")
  left = _mad(scale, -7.0, x, flip != "edges")
  right = _mad(scale, 7.0, x, flip != "edges")
  return np.stack([top, y, left, right]).astype(np.int32)


_FORMS = ("recip", "y", "scale", "pinch", "x", "top", "edges")


def _enduro_edge_cars():
  """(z, lane index) of cars whose compiled box differs from a box with
  one of `_FORMS` flipped, and the forms they show: every edge's line in
  s = sqrt(z / 400) crosses each whole pixel at one z, and the 48 f32
  values on each side of it are searched."""
  zs, lanes, shown = [], [], set()
  for li, lane in enumerate(en.LANE_X):
    d = lane - 80.0
    lines = ((160.0, -102.0), (150.0, -95.0), (80 + d - 7, 4.9 - 0.6 * d),
             (80 + d + 7, -4.9 - 0.6 * d))  # edge = a + b s
    cand = []
    for a, b in lines:
      lo, hi = sorted((a, a + b))
      for k in range(int(np.ceil(lo)), int(np.floor(hi)) + 1):
        s = (k - a) / b
        if 0 < s <= 1:
          z0 = f32(400 * s * s).view(np.int32)
          cand.append(z0 + np.arange(-48, 49, dtype=np.int32))
    z = np.concatenate(cand).view(f32)
    box = _enduro_box(z, lane)
    keep = np.zeros(z.shape, bool)
    for form in _FORMS:
      differs = (_enduro_box(z, lane, form) != box).any(0)
      if differs.any():
        shown.add(form)
      keep |= differs
    zs.append(z[keep])
    lanes.append(np.full(int(keep.sum()), li, np.int32))
  return np.concatenate(zs), np.concatenate(lanes), shown


def test_enduro_render_draws_the_compiled_boxes():
  """Cars where XLA's product with 0.0025f, its multiply-adds and its
  rounded half-width draw another box than the other form would: the
  port's render is JAX's on each, so it takes the compiled forms, one by
  one."""
  z, lane, shown = _enduro_edge_cars()
  assert shown == set(_FORMS) and len(z) > 200

  def edit(s, rng):
    del rng
    n = len(z)
    car_z = np.full((n, en.NUM_CARS), -100.0, f32)
    car_lane = np.zeros((n, en.NUM_CARS), np.int32)
    slot = np.arange(n) % en.NUM_CARS  # one car drawn, in each slot
    car_z[np.arange(n), slot] = z
    car_lane[np.arange(n), slot] = lane
    return s._replace(car_z=jnp.asarray(car_z), car_lane=jnp.asarray(
        car_lane), passed=jnp.asarray(np.arange(n) % 140 - 5, jnp.int32))

  render_sweep("enduro", edit, n=len(z))


def _enduro_edges(s, rng):
  """Cars within 2 ulps of crossing the player's z (and of the 2-unit
  collision band, the -60 recycle line) after the move, at every speed
  band, in every lane, with the player between the lanes."""
  n = s.speed.shape[0]
  speed = rng.choice(np.asarray([0.0, 0.02, 0.8, 2.4, 2.42, 5.9, 6.0], f32),
                     n)
  rel = (np.clip(speed - f32(0.02), 0, 6) - f32(en.TRAFFIC_SPEED)).astype(
      f32)
  edges = [0.0, 2.0, -2.0, -60.0, 1.0]
  car_z = near(rng, edges, n * en.NUM_CARS).reshape(n, -1) + rel[:, None]
  # No subnormals: XLA's CPU code reads them as zero, and no game reaches
  # them.
  car_z[np.abs(car_z) < np.finfo(f32).tiny] = 0.0
  return s._replace(
      speed=jnp.asarray(speed), car_z=jnp.asarray(car_z.astype(f32)),
      car_lane=jnp.asarray(rng.randint(0, 3, (n, en.NUM_CARS)), jnp.int32),
      player_x=jnp.asarray(near(rng, [52.0, 62.0, 66.0, 76.0, 90.0, 110.0],
                                n)),
      frame=jnp.asarray(rng.randint(0, en.EPISODE_FRAMES, n), jnp.int32))


# --- gopher -------------------------------------------------------------------


def test_gopher_shovel_fills_and_bonks():
  state = one_env(go, fx=45.0, holes=[0, 0, 0, 0, 2] + [0] * 11)
  s2, reward, _, _ = one_frame(go, state, 1)  # FIRE in cell 4
  assert float(reward) == go.FILL_POINTS and int(s2.holes[0, 4]) == 0
  up = one_env(go, fx=45.0, gcell=4, popped=10)
  for left_edge, cell in ((True, 0), (False, go.CELLS - 1)):
    s2, reward, _, _ = one_frame(go, up, 1, left_edge=left_edge)
    assert float(reward) == go.BONK_POINTS
    assert int(s2.gcell) == cell and int(s2.popped) == 0


def test_gopher_eats_the_nearest_carrot_and_ends_with_the_last():
  # At carrot 8 with its hole open, on a dig tick: the carrot is eaten and
  # the gopher restarts from the drawn edge.
  state = one_env(go, gcell=8, holes=[0] * 8 + [3] + [0] * 7,
                  frame=go.DIG_EVERY - 1)
  s2, _, done, _ = one_frame(go, state, 0, left_edge=False)
  assert s2.carrots.tolist() == [[True, False, True]] and not bool(done)
  assert int(s2.gcell) == go.CELLS - 1
  last = state._replace(carrots=torch.tensor([[False, True, False]]))
  _, _, done, life_lost = one_frame(go, last, 0)
  assert bool(done) and not bool(life_lost)
  # Equally near carrots: the first is the target.
  s3, _, _, _ = one_frame(go, one_env(go, gcell=5, frame=go.DIG_EVERY - 1),
                          0)
  assert int(s3.gcell) == 4


def _gopher_edges(s, rng):
  """The farmer within 2 ulps of each cell edge after his move (his cell
  is a product with 0.1f, truncated), the gopher anywhere, popped or
  not, on and off the dig and pop ticks, holes of every depth, carrots
  in every combination."""
  n = s.fx.shape[0]
  move = rng.choice(np.asarray([0.0, 2.2, -2.2], f32), n)
  fx = np.clip(near(rng, np.arange(1, 16) * 10.0, n) + move, 5.0, 155.0)
  frame = rng.choice([go.DIG_EVERY * 7 - 1, go.POP_EVERY * 2 - 1,
                      go.DIG_EVERY * go.POP_EVERY - 1, 3], n)
  return s._replace(
      fx=jnp.asarray(fx.astype(f32)),
      holes=jnp.asarray(rng.randint(0, 4, (n, go.CELLS)), jnp.int32),
      gcell=jnp.asarray(rng.randint(0, go.CELLS, n), jnp.int32),
      popped=jnp.asarray(rng.randint(0, 3, n) * 20, jnp.int32),
      carrots=jnp.asarray(rng.rand(n, 3) < 0.6),
      frame=jnp.asarray(frame, jnp.int32))


# --- ice_hockey ---------------------------------------------------------------


@pytest.mark.parametrize("puck_y,reward", [(41.0, 1.0), (184.0, -1.0)])
def test_ice_hockey_goals_are_signed_and_face_off(puck_y, reward):
  vy = -ih.SHOT_SPEED if reward > 0 else ih.SHOT_SPEED
  state = one_env(ih, puck_x=78.0, puck_y=puck_y, puck_vy=vy, ex=ih.LEFT,
                  ey=ih.TOP)
  s2, r, done, life_lost = one_frame(ih, state, 0)
  assert float(r) == reward and int(s2.faceoff_delay) == 90
  assert (float(s2.puck_x), float(s2.puck_y)) == (78.0, 114.0)
  assert not bool(done) and not bool(life_lost)


def test_ice_hockey_player_shot_aims_and_the_enemy_steals():
  # The player carries and fires: the puck leaves up at the aim's slope.
  state = one_env(ih, carrier=1, px=70.0, py=150.0, ex=ih.LEFT, ey=ih.TOP)
  s2, _, _, _ = one_frame(ih, state, 1, aim=60.0, shot_u=1.0)
  assert int(s2.carrier) == 0 and float(s2.puck_vy) == -ih.SHOT_SPEED
  slope = (f32(60.0) - f32(74.0)) / f32(150.0 - 2.0 - ih.TOP)
  assert float(s2.puck_vx) == float(np.clip(slope * f32(ih.SHOT_SPEED),
                                            -3.0, 3.0))
  # The enemy carries and the skaters overlap: the player takes it.
  state = one_env(ih, carrier=2, px=70.0, py=115.0, ex=70.0, ey=103.0)
  s2, _, _, _ = one_frame(ih, state, 0, shot_u=1.0)
  assert int(s2.carrier) == 1


def _hockey_edges(s, rng):
  """Skaters whose boxes meet within ulps (the steal, the pickups), the
  puck near both goal lines and mouths, loose, carried by either side,
  and its row near TOP + 1 and BOTTOM - 1 where the shots' divisors stop
  at 1."""
  n = s.px.shape[0]
  ex = near(rng, [60.0, 70.0, 80.0], n, ulps=3)
  ey = near(rng, [101.2, 102.0, 103.0], n, ulps=3)
  px = ex + near(rng, [-8.0, 0.0, 8.0, 2.2, -2.2], n)
  py = ey + near(rng, [14.0, 12.0, 16.2, 11.8], n)
  puck_y = near(rng, [39.0, 40.0, 41.0, 42.5, 114.0, 187.0, 188.0, 189.0],
                n) + rng.choice(np.asarray([0.0, -4.5, 4.5], f32), n)
  puck_x = near(rng, [62.0, 95.0, 78.0, 12.0, 145.0], n)
  return s._replace(
      px=jnp.asarray(np.clip(px, ih.LEFT, 140.0).astype(f32)),
      py=jnp.asarray(np.clip(py, 115.0, 178.0).astype(f32)),
      ex=jnp.asarray(ex), ey=jnp.asarray(ey),
      puck_x=jnp.asarray(puck_x), puck_y=jnp.asarray(puck_y.astype(f32)),
      puck_vx=jnp.asarray(rng.uniform(-3, 3, n).astype(f32)),
      puck_vy=jnp.asarray(rng.choice(np.asarray([0.0, -4.5, 4.5], f32), n)),
      carrier=jnp.asarray(rng.randint(0, 3, n), jnp.int32),
      faceoff_delay=jnp.asarray(rng.choice([0, 0, 0, 1, 2], n), jnp.int32))


@pytest.mark.parametrize("name,edit", [("enduro", _enduro_edges),
                                       ("gopher", _gopher_edges),
                                       ("ice_hockey", _hockey_edges)])
def test_step_on_hand_made_states_matches_jax(name, edit):
  _, reward, _ = step_sweep(name, edit, renders=128)
  assert bool((reward != 0).any())
