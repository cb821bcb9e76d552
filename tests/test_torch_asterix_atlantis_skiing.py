"""Differential tests of the port's asterix, atlantis and skiing against the
JAX package's (CPU): the vector env step for step over auto-resets, every
output and every state field exact, frames included; and the games' rules
of tests/test_new_games.py on the port's games.

Asterix and atlantis split their keys on every raw frame (a spawn test and
a kind or a direction for each lane or band), so they take per-frame draws;
skiing draws only at init. JAX's draws come from its key chain
(tests/torch_games_jax.py). The rules are tests/test_new_games.py's
single-step probes, which need no rollout: each builds a state by hand and
steps the game function once or twice."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_games_jax import near, one_env, one_frame, random_policy
from torch_games_jax import run_against_jax, step_sweep

from dqn_zoo_torch.envs.games import asterix as ax
from dqn_zoo_torch.envs.games import atlantis as at
from dqn_zoo_torch.envs.games import skiing as sk
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _asterix_end(gs):
  # Half the envs on their last life, the others at scores that take the
  # speed ramp up to and past its cap.
  b = gs.lives.shape[0]
  return gs._replace(lives=gs.lives.at[: b // 2].set(1),
                     score=gs.score.at[b // 2:].set(
                         np.linspace(50.0, 12_000.0, b - b // 2)))


def _atlantis_end(gs):
  # Half the envs with one city left and a band-0 ship about to finish its
  # pass; the others with every slot live in its own band.
  b = gs.city_live.shape[0]
  h = b // 2
  return gs._replace(
      city_live=gs.city_live.at[:h].set(False).at[:h, 0].set(True),
      ship_live=gs.ship_live.at[:, 0].set(True).at[h:].set(True),
      ship_band=gs.ship_band.at[:, 0].set(0),
      ship_x=gs.ship_x.at[:h, 0].set(
          np.where(np.asarray(gs.ship_dir[:h, 0]) > 0, 150.0, -2.0)))


def _skiing_end(gs):
  # Every env a few groups above the finish, after ~2,000 frames.
  b = gs.frames.shape[0]
  return gs._replace(
      course_y=gs.course_y.at[:].set(sk.COURSE_LEN - 6.0 * np.arange(1, b + 1)),
      frames=gs.frames.at[:].set(1990),
      gate_passed=gs.gate_passed.at[:, ::2].set(True),
      gate_judged=gs.gate_judged.at[:, :-1].set(True))


_PREPARE = {"asterix": _asterix_end, "atlantis": _atlantis_end,
            "skiing": _skiing_end}


@pytest.mark.parametrize("name", ["asterix", "atlantis", "skiing"])
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


f32 = lambda v: torch.tensor([v], dtype=torch.float32)


# --- asterix -----------------------------------------------------------------


def test_asterix_collect_scores_and_lyre_costs_life():
  state = one_env(ax)
  lane = 4
  obj_x = torch.full((1, ax.NUM_LANES), -100.0)
  obj_x[0, lane] = state.player_x[0]
  # A collectible exactly on the player.
  state = state._replace(
      obj_x=obj_x, obj_live=torch.ones_like(state.obj_live),
      obj_is_lyre=torch.zeros_like(state.obj_is_lyre),
      player_y=f32(float(ax.LANE_TOPS[lane])))
  s2, reward, done, life_lost = one_frame(ax, state, 0)
  assert float(reward) == ax.POINTS
  assert not bool(done) and not bool(life_lost)
  assert not bool(s2.obj_live[0, lane])  # consumed
  # The same geometry with a lyre: a life lost, no points.
  lyre = state.obj_is_lyre.clone()
  lyre[0, lane] = True
  state = state._replace(obj_is_lyre=lyre)
  s3, reward, done, life_lost = one_frame(ax, state, 0)
  assert float(reward) == 0.0
  assert bool(life_lost) and not bool(done)
  assert int(s3.lives) == ax.LIVES - 1
  # Out of lives: done, and no life-loss signal (terminal instead).
  state = state._replace(lives=torch.tensor([1], dtype=torch.int32))
  _, _, done, life_lost = one_frame(ax, state, 0)
  assert bool(done) and not bool(life_lost)


def test_asterix_eight_direction_movement():
  state = one_env(ax, 1)
  state = state._replace(obj_live=torch.zeros_like(state.obj_live))
  x0, y0 = float(state.player_x), float(state.player_y)
  for action, want in {1: (0, -1), 2: (1, 0), 5: (1, -1), 8: (-1, 1),
                       3: (-1, 0), 4: (0, 1), 6: (-1, -1), 7: (1, 1),
                       0: (0, 0)}.items():
    s, *_ = one_frame(ax, state, action)
    got = (np.sign(float(s.player_x) - x0), np.sign(float(s.player_y) - y0))
    assert got == want, action


# --- atlantis ----------------------------------------------------------------


def test_atlantis_center_gun_downs_ship_on_beam():
  state = one_env(at)
  slot = 2
  live = torch.zeros_like(state.ship_live)
  live[0, slot] = True
  x, band = state.ship_x.clone(), state.ship_band.clone()
  x[0, slot] = at.CENTER_GUN_X - at.SHIP_W / 2
  band[0, slot] = 3
  state = state._replace(ship_live=live, ship_x=x, ship_band=band)
  s2, reward, done, _ = one_frame(at, state, 1)  # FIRE
  assert float(reward) == 400.0  # band 3: 100·4
  assert not bool(s2.ship_live[0, slot])
  assert not bool(done)
  _, r0, _, _ = one_frame(at, state, 0)  # NOOP with the same geometry
  assert float(r0) == 0.0


def test_atlantis_death_ray_and_game_over():
  state = one_env(at)
  live = torch.zeros_like(state.ship_live)
  live[0, 0] = True
  band, dirs, x = (state.ship_band.clone(), state.ship_dir.clone(),
                   state.ship_x.clone())
  band[0, 0], dirs[0, 0], x[0, 0] = 0, 1.0, 160.5
  # A band-0 ship leaving the screen fires the death ray.
  state = state._replace(ship_live=live, ship_band=band, ship_dir=dirs,
                         ship_x=x)
  s2, _, done, _ = one_frame(at, state, 0)
  assert int(s2.city_live.sum()) == at.NUM_CITY - 1
  assert not bool(done)
  # The last city falls: game over.
  city = torch.zeros_like(state.city_live)
  city[0, 0] = True
  s3, _, done, _ = one_frame(at, state._replace(city_live=city), 0)
  assert bool(done) and int(s3.city_live.sum()) == 0


# --- skiing ------------------------------------------------------------------


def test_skiing_terminal_reward_time_plus_misses():
  state = one_env(sk)
  # Just above the finish with every gate judged and passed.
  state = state._replace(
      course_y=f32(sk.COURSE_LEN - 1.0),
      gate_passed=torch.ones_like(state.gate_passed),
      gate_judged=torch.ones_like(state.gate_judged),
      frames=torch.tensor([2000], dtype=torch.int32))
  _, reward, done, _ = one_frame(sk, state, 0)
  assert bool(done)
  np.testing.assert_allclose(float(reward), -(2001 * 100.0 / 60.0),
                             rtol=1e-5)
  # The same with every gate missed: 500 cs each.
  state = state._replace(gate_passed=torch.zeros_like(state.gate_passed))
  _, reward, done, _ = one_frame(sk, state, 0)
  assert bool(done)
  np.testing.assert_allclose(
      float(reward), -(2001 * 100.0 / 60.0 + 500.0 * sk.NUM_GATES),
      rtol=1e-5)


def test_skiing_gate_judging_and_speed():
  state = one_env(sk, 2)
  gate0_y = sk.GATE_SPACING
  # Just above gate 0 and aligned with it: a straight descent passes it.
  state = state._replace(course_y=f32(gate0_y - 2.0),
                         skier_x=state.gate_x[:, 0].clone())
  s2, _, _, _ = one_frame(sk, state, 0)
  assert bool(s2.gate_judged[0, 0]) and bool(s2.gate_passed[0, 0])
  # Far from the gate: judged, but missed.
  state = state._replace(skier_x=torch.clamp(
      state.gate_x[:, 0] + 50.0, sk.SKIER_X_MIN, sk.SKIER_X_MAX))
  s3, _, _, _ = one_frame(sk, state, 0)
  assert bool(s3.gate_judged[0, 0]) and not bool(s3.gate_passed[0, 0])
  # Turning is slower than a straight descent.
  straight, _, _, _ = one_frame(sk, state, 0)
  turning, _, _, _ = one_frame(sk, state, 1)
  assert float(straight.course_y) > float(turning.course_y)


# --- one raw frame on hand-made states, against JAX's step --------------------


def _asterix_scores(s, rng):
  """Scores 0-20,000 in steps of 50: the speed ramp's multiply-add, its cap
  included."""
  n = s.score.shape[0]
  return s._replace(score=jnp.asarray(
      50.0 * rng.randint(0, 401, n), jnp.float32))


def _atlantis_beams(s, rng):
  """Live ships within 2 ulps of each gun's reach, all guns ready."""
  n = s.ship_x.shape[0]
  speed = np.asarray(at.BAND_SPEEDS, np.float32)[np.asarray(s.ship_band)]
  centre = at.CENTER_GUN_X - at.SHIP_W / 2
  edges = np.r_[centre - 11.0, centre + 11.0, np.arange(-20.0, 170.0, 1.0)]
  sx = near(rng, edges, n * at.NUM_BANDS).reshape(n, at.NUM_BANDS)
  # The ship moves dir * speed before the test.
  x = sx - np.asarray(s.ship_dir) * speed
  return s._replace(ship_x=jnp.asarray(x.astype(np.float32)),
                    ship_live=jnp.ones_like(s.ship_live))


def _skiing_finish(s, rng):
  """At the finish after 1,000-3,000 frames with any gates passed."""
  n = s.frames.shape[0]
  return s._replace(
      course_y=jnp.full((n,), sk.COURSE_LEN - 1.0, jnp.float32),
      frames=jnp.asarray(rng.randint(1000, 3000, n), jnp.int32),
      gate_passed=jnp.asarray(rng.rand(n, sk.NUM_GATES) < 0.5))


@pytest.mark.parametrize("name,edit", [("asterix", _asterix_scores),
                                       ("atlantis", _atlantis_beams),
                                       ("skiing", _skiing_finish)])
def test_step_on_hand_made_states_matches_jax(name, edit):
  _, reward, _ = step_sweep(name, edit)
  assert bool((reward != 0).any())
