"""Differential tests of the port's bowling, boxing and beam_rider against the
JAX package's (CPU): the vector env step for step over auto-resets, every
output and every state field exact, frames included; one raw frame on
hand-made states at the edges of the games' tests; a JAX state taken in
mid-episode and converted; and the games' rules on the port's games.

Bowling draws nothing (its key is never split); boxing splits its key in
two on every raw frame (the enemy's feint test) and beam_rider in three (a
spawn test and a beam for each saucer slot), so both take per-frame draws.
JAX's draws come from its key chain (tests/torch_games_jax.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_games_jax import converted_mid_episode, life_losses_zero_discount
from torch_games_jax import near, one_env, one_frame, random_policy
from torch_games_jax import run_against_jax, step_sweep

from dqn_zoo_torch.envs.games import beam_rider as br
from dqn_zoo_torch.envs.games import bowling as bw
from dqn_zoo_torch.envs.games import boxing as bx
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _bowling_end(gs):
  # Half the envs in the second roll of the tenth frame, the others in the
  # first roll of a frame with nine pins down.
  b = gs.frame_no.shape[0]
  h = b // 2
  return gs._replace(
      frame_no=gs.frame_no.at[:h].set(9), roll_no=gs.roll_no.at[:h].set(1),
      pins=gs.pins.at[h:, 1:].set(False),
      pins_this_frame=gs.pins_this_frame.at[h:].set(9))


def _boxing_end(gs):
  # Half the envs near the end of the clock, the others one punch from a KO
  # with the boxers face to face.
  b = gs.frame.shape[0]
  h = b // 2
  return gs._replace(
      frame=gs.frame.at[:h].set(bx.EPISODE_FRAMES - 40),
      p_hits=gs.p_hits.at[h:].set(bx.KO_HITS - 1),
      e_hits=gs.e_hits.at[h:].set(bx.KO_HITS - 1),
      px=gs.px.at[h:].set(60.0), ex=gs.ex.at[h:].set(70.0),
      ey=gs.ey.at[h:].set(gs.py[h:]))


def _beam_rider_end(gs):
  # Half the envs on their last life with a saucer about to reach the
  # ship's beam, the others one kill from the next sector.
  b = gs.lives.shape[0]
  h = b // 2
  return gs._replace(
      lives=gs.lives.at[:h].set(1),
      saucer_live=gs.saucer_live.at[:h, 0].set(True),
      saucer_beam=gs.saucer_beam.at[:h, 0].set(gs.ship_beam[:h]),
      saucer_y=gs.saucer_y.at[:h, 0].set(150.0),
      kills=gs.kills.at[h:].set(br.KILLS_PER_SECTOR - 1))


_PREPARE = {"bowling": _bowling_end, "boxing": _boxing_end,
            "beam_rider": _beam_rider_end}


@pytest.mark.parametrize("name", ["bowling", "boxing", "beam_rider"])
def test_vector_env_matches_jax_step_for_step(name):
  b = 8
  seen = dict(rewards=0, game_overs=0)

  def count(before, after, out):
    seen["rewards"] += int(((out.raw_reward_sum != 0) & ~out.is_first).sum())
    seen["game_overs"] += int((out.is_last & ~out.is_truncated).sum())

  firsts = run_against_jax(name, b, 40, random_policy(name, b),
                           prepare=_PREPARE[name], on_step=count)
  assert firsts > b  # auto-resets after the first groups
  assert all(v > 0 for v in seen.values()), seen


@pytest.mark.parametrize("name", ["bowling", "boxing", "beam_rider"])
def test_converted_mid_episode_state_renders_and_steps_as_jax(name):
  jstate = converted_mid_episode(name)
  assert bool((np.asarray(jstate.episode_frames) > 100).all())


# --- bowling -----------------------------------------------------------------


def test_bowling_roll_scores_each_pin_and_settles():
  state, reward, _, _ = one_frame(bw, one_env(bw), 1)  # FIRE: release
  assert float(state.ball_x) == bw.BOWLER_X + 10.0 + bw.BALL_SPEED
  total = float(reward)
  while float(state.ball_x) >= 0:
    state, reward, done, life_lost = one_frame(bw, state, 0)
    total += float(reward)
    assert not bool(done) and not bool(life_lost)
  standing = int(state.pins.sum())
  assert total == bw.NUM_PINS - standing and 0 < standing < bw.NUM_PINS
  assert int(state.roll_no) == 1 and int(state.settle) == bw.SETTLE_FRAMES
  # While the pins settle, FIRE and UP do nothing.
  moved, _, _, _ = one_frame(bw, state, 2)
  fired, _, _, _ = one_frame(bw, state, 1)
  assert float(moved.bowler_y) == float(state.bowler_y)
  assert float(fired.ball_x) == -1.0


@pytest.mark.parametrize("roll_no,bonus", [(0, bw.STRIKE_BONUS),
                                           (1, bw.SPARE_BONUS)])
def test_bowling_strike_and_spare_bonuses(roll_no, bonus):
  # One pin left, the nearest, with the ball rolling straight at it.
  pins = [True] + [False] * (bw.NUM_PINS - 1)
  state = one_env(bw, pins=pins, pins_this_frame=9, roll_no=roll_no,
                  ball_x=100.0, ball_y=bw.PIN_CY, hooked=True)
  total = 0.0
  while float(state.ball_x) >= 0:
    state, reward, done, _ = one_frame(bw, state, 0)
    total += float(reward)
  assert total == 1.0 + bonus
  assert int(state.frame_no) == 1 and int(state.roll_no) == 0
  assert bool(state.pins.all()) and int(state.pins_this_frame) == 0
  assert not bool(done)


def test_bowling_ends_after_the_tenth_frame():
  state = one_env(bw, frame_no=9, roll_no=1, ball_x=156.0, ball_y=62.0)
  state, reward, done, life_lost = one_frame(bw, state, 0)
  assert float(reward) == 0.0 and bool(done) and not bool(life_lost)
  assert int(bw.GAME.lives(state)) == 1


# --- boxing ------------------------------------------------------------------


def _face_to_face(**fields):
  return one_env(bx, px=60.0, py=100.0, ex=70.0, ey=100.0, **fields)


def test_boxing_player_punch_lands_and_shoves():
  state, reward, done, _ = one_frame(bx, _face_to_face(), 1, feint=False)
  assert float(reward) == 1.0 and not bool(done)
  assert int(state.p_hits) == 1 and int(state.p_cool) == bx.COOLDOWN
  assert int(state.p_punch) == bx.PUNCH_FRAMES
  # The enemy closed by 1.4 before the shove of 6.
  assert float(state.ex) == float(np.float32(70.0) + np.float32(1.4)) + 6.0
  # Cooling down: FIRE again does nothing.
  again, reward, _, _ = one_frame(bx, state, 1, feint=False)
  assert float(reward) == 0.0 and int(again.p_hits) == 1


@pytest.mark.parametrize("feint", [True, False])
def test_boxing_enemy_counterpunches_on_its_feint_draw(feint):
  state, reward, _, _ = one_frame(bx, _face_to_face(e_cool=0), 0,
                                  feint=feint)
  assert float(reward) == (-1.0 if feint else 0.0)
  assert int(state.e_hits) == int(feint)
  assert float(state.px) == (54.0 if feint else 60.0)


@pytest.mark.parametrize("fields,action", [
    (dict(frame=bx.EPISODE_FRAMES - 1), 0),
    (dict(p_hits=bx.KO_HITS - 1), 1),
    (dict(e_hits=bx.KO_HITS - 1, e_cool=0), 0)])
def test_boxing_bout_ends_on_the_clock_or_a_ko(fields, action):
  state = _face_to_face(**fields)
  _, _, done, life_lost = one_frame(bx, state, action, feint=True)
  assert bool(done) and not bool(life_lost)
  _, _, done, _ = one_frame(bx, _face_to_face(), 0, feint=False)
  assert not bool(done)


# --- beam_rider --------------------------------------------------------------


def _saucers(state, beams, ys, live):
  return state._replace(
      saucer_beam=torch.tensor([beams], dtype=torch.int32),
      saucer_y=torch.tensor([ys], dtype=torch.float32),
      saucer_live=torch.tensor([live]))


def test_beam_rider_laser_kills_the_last_saucer_hit():
  state = one_env(br, ship_beam=2, shot_live=True, shot_beam=2,
                  shot_y=110.0)
  # Two saucers overlap the shot on its beam: one kill, the last slot.
  state = _saucers(state, [2, 2, 0], [100.0, 101.0, 60.0],
                   [True, True, True])
  state, reward, _, _ = one_frame(br, state, 0, spawn_u=[1.0] * 3)
  assert float(reward) == br.SAUCER_POINTS
  assert state.saucer_live.tolist() == [[True, False, True]]
  assert not bool(state.shot_live) and int(state.kills) == 1


def test_beam_rider_torpedo_clears_the_ship_beam():
  state = _saucers(one_env(br, ship_beam=1), [1, 1, 3],
                   [80.0, 120.0, 80.0], [True, True, True])
  state, reward, _, _ = one_frame(br, state, 2, spawn_u=[1.0] * 3)  # UP
  assert float(reward) == 2 * br.TORPEDO_POINTS
  assert int(state.torpedoes) == br.TORPEDOES_PER_SECTOR - 1
  assert state.saucer_live.tolist() == [[False, False, True]]
  # The fifteenth kill starts a new sector with fresh torpedoes.
  state = _saucers(one_env(br, ship_beam=1, kills=14, torpedoes=1),
                   [1, 0, 0], [80.0, 60.0, 60.0], [True, False, False])
  state, _, _, _ = one_frame(br, state, 2, spawn_u=[1.0] * 3)
  assert int(state.sector) == 1 and int(state.kills) == 0
  assert int(state.torpedoes) == br.TORPEDOES_PER_SECTOR


def test_beam_rider_crash_costs_a_life():
  state = _saucers(one_env(br, ship_beam=4), [4, 0, 0],
                   [br.SHIP_Y - br.SAUCER_H, 60.0, 60.0],
                   [True, False, False])
  s2, _, done, life_lost = one_frame(br, state, 0, spawn_u=[1.0] * 3)
  assert bool(life_lost) and not bool(done)
  assert int(s2.lives) == br.LIVES - 1 and int(s2.hit_pause) == br.HIT_PAUSE
  last = state._replace(lives=torch.tensor([1], dtype=torch.int32))
  _, _, done, life_lost = one_frame(br, last, 0, spawn_u=[1.0] * 3)
  assert bool(done) and not bool(life_lost)


def test_beam_rider_life_loss_zero_discount():
  assert life_losses_zero_discount("beam_rider", 8, 200, 2) > 0


# --- one raw frame on hand-made states, against JAX's step --------------------


def _bowling_pins(s, rng):
  """Balls that move onto the rim of a pin's circle, within 2 ulps: the
  squared distance's multiply-add against the radius."""
  n = s.ball_x.shape[0]
  xy = bw._PIN_XY[rng.randint(0, bw.NUM_PINS, n)]
  dx = rng.randint(-6, 7, n).astype(np.float32)
  side = np.where(rng.rand(n) < 0.5, -1.0, 1.0).astype(np.float32)
  dy = side * np.sqrt(36.0 - dx * dx).astype(np.float32)
  ball_y = np.array([near(rng, [y], 1)[0] for y in xy[:, 1] + dy])
  return s._replace(
      ball_x=jnp.asarray(xy[:, 0] - dx - bw.BALL_SPEED),
      ball_y=jnp.asarray(ball_y, jnp.float32),
      hooked=jnp.ones_like(s.hooked),
      pins_this_frame=jnp.asarray(rng.randint(0, 10, n), jnp.int32),
      roll_no=jnp.asarray(rng.randint(0, 2, n), jnp.int32))


def _boxing_ranges(s, rng):
  """Boxers at the edges of the enemy's gap rule, the alignment window and
  the punch reach, within 2 ulps, with both cooldowns over."""
  n = s.px.shape[0]
  px = rng.uniform(34.0, 110.0, n).astype(np.float32)
  gap = near(rng, [-12.0, -4.0, -14.0, -15.4, -12.6, -2.6, -5.4], n)
  py = rng.uniform(50.0, 150.0, n).astype(np.float32)
  dy = near(rng, [14.0, -14.0, 15.4, -15.4, 12.6, -12.6, 0.0], n)
  f32 = lambda v: jnp.asarray(np.asarray(v, np.float32))
  return s._replace(px=f32(px), ex=f32(px + 8.0 - gap), py=f32(py),
                    ey=f32(np.clip(py - dy, 45.0, 156.0)),
                    e_cool=jnp.zeros_like(s.e_cool))


def _beam_rider_contacts(s, rng):
  """A live shot and saucers on one beam at the edges of the hit test and
  of the ship's row, within 2 ulps, in sectors 0-20."""
  n = s.shot_y.shape[0]
  sector = rng.randint(0, 21, n)
  speed = (np.float32(br.SAUCER_SPEED)
           + np.float32(0.25) * sector.astype(np.float32))
  y = rng.uniform(50.0, 170.0, n).astype(np.float32)
  shot_y = np.where(rng.rand(n) < 0.5, y + speed + 12.0, y + speed)
  saucer_y = np.stack([y, near(rng, [br.SHIP_Y - br.SAUCER_H], n) - speed,
                       y + 3.0], axis=1).astype(np.float32)
  beam = np.asarray(s.ship_beam)
  return s._replace(
      sector=jnp.asarray(sector, jnp.int32),
      shot_y=jnp.asarray(near(rng, [0.0], n) + shot_y.astype(np.float32)),
      shot_live=jnp.ones_like(s.shot_live),
      shot_beam=s.ship_beam,
      saucer_beam=jnp.asarray(np.stack([beam] * br.NUM_SAUCERS, 1),
                              jnp.int32),
      saucer_y=jnp.asarray(saucer_y),
      saucer_live=jnp.ones_like(s.saucer_live))


@pytest.mark.parametrize("name,edit", [("bowling", _bowling_pins),
                                       ("boxing", _boxing_ranges),
                                       ("beam_rider", _beam_rider_contacts)])
def test_step_on_hand_made_states_matches_jax(name, edit):
  _, reward, _ = step_sweep(name, edit)
  assert bool((reward != 0).any())
