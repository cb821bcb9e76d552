"""Differential tests of the port's star_gunner and tennis against the JAX
package's (CPU): the vector env step for step over auto-resets, every
output and every state field exact, frames included; one raw frame on
hand-made states at the edges of the games' tests and where XLA's compiled
forms and the source's plain ones give other bits; a JAX state taken in
mid-episode and converted; and the games' rules on the port's games.

Star_gunner splits its key in four on every raw frame (each raider's jink,
respawn row and bolt test) and in three at init; tennis splits in three on
every raw frame (a serve's x speed and the fumble coin) and draws nothing
at init. JAX's draws come from its key chain (tests/torch_games_jax.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_games_jax import converted_mid_episode
from torch_games_jax import life_losses_zero_discount, near, one_env
from torch_games_jax import one_frame, random_policy, run_against_jax
from torch_games_jax import step_sweep

from dqn_zoo_torch.envs.api import get_game
from dqn_zoo_torch.envs.games import star_gunner as sg
from dqn_zoo_torch.envs.games import tennis as te
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

f32 = np.float32
GAMES = ["star_gunner", "tennis"]


def _star_gunner_end(gs):
  # Every env on its last life with the bolts' pause over; half of them
  # with raider 0 live on the ship.
  b = gs.lives.shape[0]
  h = b // 2
  return gs._replace(
      lives=gs.lives.at[:].set(1), hit_pause=gs.hit_pause.at[:].set(0),
      rlive=gs.rlive.at[:h, 0].set(True),
      rx=gs.rx.at[:h, 0].set(gs.sx[:h] + 4.0),
      ry=gs.ry.at[:h, 0].set(gs.sy[:h]))


def _tennis_end(gs):
  # Half the envs one point from the set's end with the ball in play over
  # the far baseline, the others near the end of the clock.
  b = gs.frame.shape[0]
  h = b // 2
  return gs._replace(
      points=gs.points.at[:h].set(te.POINTS_PER_EPISODE - 1),
      serve_timer=gs.serve_timer.at[:h].set(0),
      by=gs.by.at[:h].set(te.COURT_TOP + 1.0),
      bvy=gs.bvy.at[:h].set(-te.BALL_SPEED_Y),
      bx=gs.bx.at[:h].set(te.COURT_L + 2.0),
      frame=gs.frame.at[h:].set(te.EPISODE_FRAMES - 40))


_PREPARE = {"star_gunner": _star_gunner_end, "tennis": _tennis_end}


@pytest.mark.parametrize("name", GAMES)
def test_vector_env_matches_jax_step_for_step(name):
  b = 8
  seen = dict(rewards=0, game_overs=0)
  if name == "star_gunner":
    seen["life_losses"] = 0

  def count(before, after, out):
    live = ~out.is_first
    seen["rewards"] += int(((out.raw_reward_sum != 0) & live).sum())
    seen["game_overs"] += int((out.is_last & ~out.is_truncated).sum())
    if "life_losses" in seen:
      seen["life_losses"] += int(((after.game_state.lives
                                   < before.game_state.lives)
                                  & live & ~out.is_last).sum())

  policy = random_policy(name, b)
  if name == "star_gunner":
    # Half the envs keep firing, the others play at random: kills, and
    # lives lost to the raiders.
    policy = lambda step, state, p=policy: np.where(
        np.arange(b) < b // 2, 1, p(step, state))
  firsts = run_against_jax(name, b, 32, policy, prepare=_PREPARE[name],
                           on_step=count)
  assert firsts > b  # auto-resets after the first groups
  assert all(v > 0 for v in seen.values()), seen


@pytest.mark.parametrize("name", GAMES)
def test_converted_mid_episode_state_renders_and_steps_as_jax(name):
  jstate = converted_mid_episode(name, b=8)
  assert float(np.median(np.asarray(jstate.episode_frames))) > 40


def test_star_gunner_life_loss_zero_discount():
  assert life_losses_zero_discount("star_gunner", 8, 150, 3) > 0


# --- star_gunner --------------------------------------------------------------

_CALM = dict(jink=[0.0] * sg.NUM_RAIDERS, spawn_y=[100.0] * sg.NUM_RAIDERS,
             bolt_u=[1.0] * sg.NUM_RAIDERS)


def test_star_gunner_laser_kills_the_first_raider_hit():
  # Raiders 1 and 2 share a box in front of the laser: raider 1 alone dies
  # and pays 100; the kill counts toward the waves.
  state = one_env(sg, sx=20.0, sy=96.0, rx=[150.0, 60.0, 60.0],
                  ry=[40.0, 97.0, 97.0], rlive=[False, True, True],
                  rdelay=[50, 0, 0], shot_live=True, shot_x=50.0,
                  shot_y=100.0, wave=9)
  s2, reward, _, _ = one_frame(sg, state, 0, **_CALM)
  assert float(reward) == sg.RAIDER_POINTS and int(s2.wave) == 10
  assert s2.rlive.tolist() == [[False, False, True]]
  assert int(s2.rdelay[0, 1]) == sg.SPAWN_DELAY and not bool(s2.shot_live)
  # At 10 kills the live raider sweeps left at 1.3 + 0.3, one
  # multiply-add: 0x3fcccccc, the tie below 1.6f rounded to even.
  s3, _, _, _ = one_frame(sg, s2, 0, **_CALM)
  speed = f32(np.float64(f32(0.3)) + np.float64(f32(1.3)))
  assert speed.view(np.int32) == 0x3fcccccc
  assert float(s3.rx[0, 2]) == float(s2.rx[0, 2] - torch.tensor(speed))


def test_star_gunner_bolt_costs_a_life_then_a_pause():
  state = one_env(sg, sx=30.0, sy=100.0, blive=[True, False, False],
                  bx=[44.0, 0.0, 0.0], by=[101.0, 0.0, 0.0],
                  rlive=[False] * 3, rdelay=[50] * 3, lives=2)
  s2, reward, done, life_lost = one_frame(sg, state, 0, **_CALM)
  assert bool(life_lost) and not bool(done) and float(reward) == 0.0
  assert int(s2.lives) == 1 and int(s2.hit_pause) == sg.HIT_PAUSE
  assert not bool(s2.blive.any())
  # During the pause a raider's ram costs nothing; off it, the last life.
  ram = dict(rlive=[True, False, False], rx=[34.0, 150.0, 150.0],
             ry=[100.0, 40.0, 40.0])
  s3, _, done, life_lost = one_frame(sg, s2._replace(**{
      k: torch.tensor([v], dtype=getattr(s2, k).dtype)
      for k, v in ram.items()}), 0, **_CALM)
  assert int(s3.lives) == 1 and not bool(done) and not bool(life_lost)
  s4, _, done, life_lost = one_frame(sg, one_env(
      sg, sx=30.0, sy=100.0, lives=1, **ram), 0, **_CALM)
  assert bool(done) and not bool(life_lost) and int(s4.lives) == 0


def _star_gunner_edges(s, rng):
  """Kills 0-400 (the speed's multiply-add over 41 wave steps), raiders
  jinking at any velocity (the jink's multiply-add shows in `rvy` on every
  raider), rows within ulps of the walls; the laser within ulps of the
  boxes of two raiders that share a column (the first hit dies); bolts
  and raiders within ulps of the ship's box, with the pause on and off."""
  n = s.lives.shape[0]
  k = sg.NUM_RAIDERS
  sy = near(rng, [40.0, 100.0, 150.0, 188.0], n)
  sx = near(rng, [8.0, 40.0, 76.0], n)
  ry = np.where(rng.rand(n, k) < 0.5, near(rng, [40.0, 189.0], n * k)
                .reshape(n, k), rng.uniform(40, 189, (n, k)).astype(f32))
  rx = rng.uniform(0, 152, (n, k)).astype(f32)
  shared = rng.randint(0, k - 1, n)
  rows = np.arange(n)
  rx[rows, shared + 1] = rx[rows, shared]
  ry[rows, shared + 1] = ry[rows, shared] + rng.choice(
      np.asarray([0.0, 1.0, -2.0], f32), n)
  shot_x = rx[rows, shared] + near(rng, [-13.0, -7.0, 3.0, -3.0], n)
  shot_y = ry[rows, shared] + near(rng, [0.0, 7.0, 3.5, -0.5], n)
  near_ship = rng.rand(n, k) < 0.3
  bx = np.where(near_ship, sx[:, None] + near(
      rng, [14.4, 12.4, -3.0, -0.6, 6.0], n * k).reshape(n, k),
                rng.uniform(0, 160, (n, k)).astype(f32))
  by = np.where(near_ship, sy[:, None] + near(
      rng, [-3.0, 8.0, -1.8, 9.2, 4.0], n * k).reshape(n, k),
                rng.uniform(40, 196, (n, k)).astype(f32))
  rx = np.where(near_ship & (rng.rand(n, k) < 0.5), sx[:, None] + near(
      rng, [13.3, -8.7, 0.0], n * k).reshape(n, k), rx)
  return s._replace(
      sx=jnp.asarray(sx), sy=jnp.asarray(sy),
      rx=jnp.asarray(rx.astype(f32)), ry=jnp.asarray(ry.astype(f32)),
      rvy=jnp.asarray(rng.uniform(-2, 2, (n, k)).astype(f32)),
      rlive=jnp.asarray(rng.rand(n, k) < 0.85),
      rdelay=jnp.asarray(rng.choice([0, 1, 2, 30], (n, k)), jnp.int32),
      shot_x=jnp.asarray(shot_x.astype(f32)),
      shot_y=jnp.asarray(shot_y.astype(f32)),
      shot_live=jnp.asarray(rng.rand(n) < 0.8),
      bx=jnp.asarray(bx.astype(f32)), by=jnp.asarray(by.astype(f32)),
      blive=jnp.asarray(rng.rand(n, k) < 0.7),
      lives=jnp.asarray(rng.randint(1, 6, n), jnp.int32),
      wave=jnp.asarray(rng.randint(0, 401, n), jnp.int32),
      hit_pause=jnp.asarray(rng.choice([0, 0, 1, 20], n), jnp.int32))


# --- tennis -------------------------------------------------------------------

_VY = float(f32(te.BALL_SPEED_Y))


def test_tennis_has_no_lives_and_ends_at_24_points():
  assert te.GAME.num_actions == 18 and get_game("tennis") is te.GAME
  state = one_env(te, points=te.POINTS_PER_EPISODE - 1, serve_timer=0,
                  bx=60.0, by=te.COURT_BOT - 1.0, bvx=0.5,
                  bvy=te.BALL_SPEED_Y, px=120.0)
  assert te.GAME.lives(state).tolist() == [1]
  s2, reward, done, life_lost = one_frame(te, state, 0, miss=False)
  assert float(reward) == -1.0 and bool(done) and not bool(life_lost)
  assert int(s2.serve_timer) == te.SERVE_DELAY
  assert not bool(s2.serve_to_player)  # the winner of the point serves
  assert (float(s2.bx), float(s2.by)) == (80.0, te.NET_Y)


def test_tennis_serve_return_and_fumble():
  # The serve's last dead frame puts the ball in play at the drawn speed.
  state = one_env(te, serve_timer=1)
  s2, _, _, _ = one_frame(te, state, 0, serve_vx=-1.5)
  assert float(s2.bvx) == -1.5 and float(s2.bvy) == _VY
  assert float(s2.bx) == 78.5 and int(s2.serve_timer) == 0
  # The player meets a falling ball 3 px right of centre: it leaves up at
  # bvx + 3 * 2.2 / 7, one multiply-add, clipped to 3.2.
  state = one_env(te, serve_timer=0, px=80.0, bx=83.0, bvx=0.0,
                  by=te.PLAYER_Y - 2.6, bvy=te.BALL_SPEED_Y)
  s2, _, _, _ = one_frame(te, state, 0, miss=False)
  gain = f32(2.2) * f32(1 / np.float32(7))
  assert float(s2.bvx) == float(f32(3.0) * gain)
  assert float(s2.bvy) == -_VY
  # The opponent fumbles a fast ball on the coin: it flies past.
  state = one_env(te, serve_timer=0, ox=60.0, bx=60.0, bvx=2.0,
                  by=te.OPP_Y + 2.6, bvy=-te.BALL_SPEED_Y)
  s2, _, _, _ = one_frame(te, state, 0, miss=True)
  assert float(s2.bvy) == -_VY
  s3, _, _, _ = one_frame(te, state, 0, miss=False)
  assert float(s3.bvy) == _VY


def _tennis_edges(s, rng):
  """The ball in play within ulps of the paddles' reach (rows and the
  9-px offset) and of the baselines and walls after its move, at speeds
  within ulps of the fumble's 1.8 and the clip's 3.2 and anywhere between
  (the returns' multiply-adds with 2.2/7 and 2/7 give other bits than the
  two roundings or the source's division at most offsets); serves on
  their last dead frame; points and the clock at the episode's end."""
  n = s.px.shape[0]
  bvy = rng.choice(np.asarray([2.6, -2.6], f32), n)
  rows = [176.0, 185.0, 46.0, 55.0, 40.0, 190.0, 178.5, 50.0]
  by = (near(rng, rows, n) - bvy).astype(f32)
  bvx = np.where(rng.rand(n) < 0.5, near(rng, [1.8, -1.8, 3.2, -3.2], n),
                 rng.uniform(-3.2, 3.2, n).astype(f32))
  px = rng.uniform(23.0, 137.0, n).astype(f32)
  bx = (px + np.where(rng.rand(n) < 0.5, near(rng, [-9.0, 9.0], n),
                      rng.uniform(-9, 9, n).astype(f32)) - bvx).astype(f32)
  bx = np.where(rng.rand(n) < 0.1, near(rng, [16.0, 144.0], n) - bvx, bx)
  ox = (bx + bvx + np.where(rng.rand(n) < 0.5, near(rng, [-9.0, 9.0], n),
                            rng.uniform(-9, 9, n).astype(f32))).astype(f32)
  # The opponent moves before the ball: start it where its move lands.
  ox = np.clip(ox - np.clip(bx - ox, -3.4, 3.4), 23.0, 137.0).astype(f32)
  return s._replace(
      px=jnp.asarray(np.clip(px, 23.0, 137.0)), ox=jnp.asarray(ox),
      bx=jnp.asarray(bx.astype(f32)), by=jnp.asarray(by),
      bvx=jnp.asarray(bvx.astype(f32)), bvy=jnp.asarray(bvy),
      serve_timer=jnp.asarray(rng.choice([0, 0, 0, 1, 5], n), jnp.int32),
      serve_to_player=jnp.asarray(rng.rand(n) < 0.5),
      points=jnp.asarray(rng.choice([0, 10, 23], n), jnp.int32),
      frame=jnp.asarray(rng.choice([100, te.EPISODE_FRAMES - 1], n),
                        jnp.int32))


@pytest.mark.parametrize("name,edit", [("star_gunner", _star_gunner_edges),
                                       ("tennis", _tennis_edges)])
def test_step_on_hand_made_states_matches_jax(name, edit):
  _, reward, _ = step_sweep(name, edit, renders=128)
  assert bool((reward != 0).any())
