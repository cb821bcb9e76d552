"""Differential tests of the port's qbert and zaxxon against the JAX
package's (CPU): the vector env step for step over auto-resets, every
output and every state field exact, frames included; one raw frame on
hand-made states at the edges of the games' tests; a JAX state taken in
mid-episode and converted; and the games' rules on the port's games.

Qbert splits its key in three on every raw frame and draws the ball's
spawn side from one part and its hop side from that part folded with 1
(`fold_in`), Coily's tie-breaks from another; it draws nothing at init.
Zaxxon splits its key in 2 + 4 at init and in three on every raw frame,
one key for each enemy's spawn, which it splits again into the x offset,
the y and the turret coin. JAX's draws come from its key chain
(tests/torch_games_jax.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_games_jax import converted_mid_episode
from torch_games_jax import life_losses_zero_discount, near, one_env
from torch_games_jax import one_frame, random_policy, run_against_jax
from torch_games_jax import step_sweep

from dqn_zoo_torch.envs.api import get_game
from dqn_zoo_torch.envs.games import qbert as qb
from dqn_zoo_torch.envs.games import zaxxon as za
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

f32 = np.float32
GAMES = ["qbert", "zaxxon"]


def test_vector_env_runs_on_the_card_unless_asked_for_the_cpu():
  from dqn_zoo_torch.envs.vector import VectorAtariEnv
  if torch.cuda.is_available():
    pytest.skip("checks the error raised where no card is")
  with pytest.raises(RuntimeError, match="CUDA is not available"):
    VectorAtariEnv(get_game("zaxxon"), 4)
  env = VectorAtariEnv(get_game("zaxxon"), 4, device="cpu")
  gen = torch.Generator().manual_seed(0)
  state, out = env.step(env.init(gen), torch.zeros(4, dtype=torch.int64),
                        env.draws(gen))
  assert env.device == torch.device("cpu") and bool(out.is_first.all())
  assert out.frame_last.shape == (4, 210, 160, 3)
  assert state.game_state.enemy_x.device.type == "cpu"


def _qbert_end(gs):
  # Every env on its last life, half of them on the bottom row (a hop
  # down falls off).
  b = gs.lives.shape[0]
  h = b // 2
  return gs._replace(lives=gs.lives.at[:].set(1),
                     pr=gs.pr.at[:h].set(qb.N - 1), pc=gs.pc.at[:h].set(2))


def _zaxxon_end(gs):
  # Half the envs on their last life with the wall about to reach the
  # ship and its gap far above it.
  b = gs.lives.shape[0]
  h = b // 2
  return gs._replace(lives=gs.lives.at[:h].set(1),
                     wall_x=gs.wall_x.at[:h].set(60.0),
                     gap_y=gs.gap_y.at[:h].set(70.0),
                     ship_y=gs.ship_y.at[:h].set(150.0))


_PREPARE = {"qbert": _qbert_end, "zaxxon": _zaxxon_end}


@pytest.mark.parametrize("name", GAMES)
def test_vector_env_matches_jax_step_for_step(name):
  b = 8
  seen = dict(rewards=0, game_overs=0, life_losses=0)

  def count(before, after, out):
    live = ~out.is_first
    seen["rewards"] += int(((out.raw_reward_sum != 0) & live).sum())
    seen["game_overs"] += int((out.is_last & ~out.is_truncated).sum())
    seen["life_losses"] += int(((after.game_state.lives
                                 < before.game_state.lives)
                                & live & ~out.is_last).sum())

  firsts = run_against_jax(name, b, 32, random_policy(name, b),
                           prepare=_PREPARE[name], on_step=count)
  assert firsts > b  # auto-resets after the first groups
  assert all(v > 0 for v in seen.values()), seen


@pytest.mark.parametrize("name", GAMES)
def test_converted_mid_episode_state_renders_and_steps_as_jax(name):
  jstate = converted_mid_episode(name, b=8)
  assert float(np.median(np.asarray(jstate.episode_frames))) > 40


@pytest.mark.parametrize("name", GAMES)
def test_life_loss_zero_discount(name):
  # Random play loses a first life within ~40 groups in both games.
  assert life_losses_zero_discount(name, 8, 80, 3) > 0


# --- qbert --------------------------------------------------------------------

_STILL = dict(ball_side=False, ball_hop=False, coily_u=[0.0] * 4)


def _board(*uncoloured):
  """A (7, 7) board with every cube coloured but the given (r, c)."""
  board = np.tril(np.ones((qb.N, qb.N), bool))
  for r, c in uncoloured:
    board[r, c] = False
  return board.tolist()


def test_qbert_28th_cube_pays_the_bonus_and_clears_the_board():
  # One hop (RIGHT: down-right) from (5, 2) onto the last cube, (6, 3).
  state = one_env(qb, pr=5, pc=2, colored=_board((6, 3)),
                  frame=qb.HOP_PERIOD - 1)
  s2, reward, done, life_lost = one_frame(qb, state, 3, **_STILL)
  assert float(reward) == qb.CUBE_POINTS + qb.ROUND_BONUS
  assert (int(s2.pr), int(s2.pc)) == (6, 3)
  assert not bool(s2.colored.any()) and not bool(done | life_lost)
  # Off the hop tick the stick does nothing; a coloured cube pays nothing.
  s3, reward, _, _ = one_frame(qb, state._replace(
      frame=torch.tensor([3], dtype=torch.int32)), 3, **_STILL)
  assert float(reward) == 0.0 and (int(s3.pr), int(s3.pc)) == (5, 2)


def test_qbert_falls_off_the_edge_and_coily_chases():
  # UP from (3, 3) leaves the pyramid (row 2 has no column 3): a life, the
  # player back on the apex, the apex scored again if uncoloured.
  state = one_env(qb, pr=3, pc=3, frame=qb.HOP_PERIOD * 3 - 1, cr=1, cc=0)
  s2, reward, done, life_lost = one_frame(qb, state, 2, **_STILL)
  assert bool(life_lost) and not bool(done)
  assert (int(s2.pr), int(s2.pc), int(s2.cr)) == (0, 0, -1)
  assert int(s2.freeze) == qb.DEATH_FREEZE and float(reward) == 25.0
  # Coily on the player's cube (4, 2): the hops up and down its column,
  # (3, 2) and (5, 2), are equally near; the lower tie-break wins, and on
  # a tie the first.
  chase = one_env(qb, pr=4, pc=2, cr=4, cc=2, frame=qb.COILY_PERIOD * 3 - 1)
  for u, want in (([0, 0.2, 0.1, 0], (5, 2)), ([0, 0.1, 0.2, 0], (3, 2)),
                  ([0, 0, 0, 0], (3, 2))):
    s3, _, _, _ = one_frame(qb, chase, 0, ball_side=False, ball_hop=False,
                            coily_u=u)
    assert (int(s3.cr), int(s3.cc)) == want, u


def _qbert_edges(s, rng):
  """The player on every cube, on and off the hop tick, and at the first
  frame (the apex scored); boards one cube from complete (round ends);
  Coily next to the player with its tie-breaks drawn (the pick), hatching
  or frozen; the ball spawning, hopping and rolling off the bottom; every
  life count."""
  n = s.lives.shape[0]
  pr = rng.randint(0, qb.N, n)
  pc = (rng.rand(n) * (pr + 1)).astype(np.int32)
  tri = np.tril(np.ones((qb.N, qb.N), bool))
  colored = np.broadcast_to(tri, (n, qb.N, qb.N)).copy()
  # Half the boards miss one random cube, the others are random.
  miss_r = rng.randint(0, qb.N, n)
  miss_c = (rng.rand(n) * (miss_r + 1)).astype(np.int32)
  colored[np.arange(n), miss_r, miss_c] = False
  colored = np.where((rng.rand(n) < 0.5)[:, None, None], colored,
                     tri & (rng.rand(n, qb.N, qb.N) < 0.5))
  cr = np.clip(pr + rng.randint(-2, 2, n), -1, qb.N - 1)
  cc = np.clip(pc + rng.randint(-1, 2, n), 0, np.maximum(cr, 0))
  br = rng.randint(-1, qb.N, n)
  bc = (rng.rand(n) * (np.maximum(br, 0) + 1)).astype(np.int32)
  # Frames just before the ticks of the hop (16), the ball (18), Coily
  # (20), their products, the ball's spawn (280) and the hatch (140).
  frame = rng.choice([0, 15, 17, 19, 79, 143, 179, 719, 139, 140, 279, 559,
                      qb.EPISODE_FRAMES - 1], n)
  return s._replace(
      pr=jnp.asarray(pr, jnp.int32), pc=jnp.asarray(pc, jnp.int32),
      colored=jnp.asarray(colored), cr=jnp.asarray(cr, jnp.int32),
      cc=jnp.asarray(cc, jnp.int32), br=jnp.asarray(br, jnp.int32),
      bc=jnp.asarray(bc, jnp.int32),
      lives=jnp.asarray(rng.randint(1, qb.LIVES + 1, n), jnp.int32),
      freeze=jnp.asarray(rng.choice([0, 0, 0, 1, 5], n), jnp.int32),
      frame=jnp.asarray(frame, jnp.int32))


# --- zaxxon -------------------------------------------------------------------

_NO_SPAWN = dict(spawn_dx=[10.0] * za.NUM_ENEMIES,
                 spawn_y=[100.0] * za.NUM_ENEMIES,
                 spawn_turret=[False] * za.NUM_ENEMIES, gap_y=100.0)
_CLEAR = dict(wall_x=300.0, enemy_x=[150.0, 170.0, 190.0, 210.0],
              enemy_y=[60.0] * 4, enemy_turret=[False] * 4)


def test_zaxxon_shot_kills_the_first_target_a_turret_pays_100():
  # Enemies 1 and 2 (a turret, then a drone) share a box ahead of the
  # shot: the turret alone dies and is recycled from the draws.
  clear = dict(_CLEAR, enemy_x=[150.0, 80.0, 80.0, 210.0],
               enemy_y=[60.0, 172.0, 172.0, 60.0],
               enemy_turret=[False, True, False, False])
  state = one_env(za, shot_x=70.0, shot_y=173.0, **clear)
  s2, reward, done, life_lost = one_frame(za, state, 0, **_NO_SPAWN)
  assert float(reward) == za.TURRET_POINTS and float(s2.shot_x) == -1.0
  assert s2.enemy_x.tolist() == [[148.0, 230.0, 78.0, 208.0]]
  assert s2.enemy_turret.tolist() == [[False, False, False, False]]
  assert bool(s2.enemy_alive.all()) and not bool(done | life_lost)


def test_zaxxon_wall_outside_the_gap_costs_a_life_and_pushes_enemies():
  crash = dict(_CLEAR, wall_x=40.0, gap_y=70.0, ship_y=150.0,
               enemy_x=[100.0, 130.0, 150.0, 210.0])
  state = one_env(za, **crash)
  s2, reward, done, life_lost = one_frame(za, state, 0, **_NO_SPAWN)
  assert bool(life_lost) and not bool(done) and float(reward) == 0.0
  assert int(s2.lives) == za.LIVES - 1 and int(s2.freeze) == za.DEATH_FREEZE
  assert float(s2.ship_y) == 110.0 and float(s2.wall_x) == 398.0
  # Enemies left of 120 after the scroll are pushed on by 200.
  assert s2.enemy_x.tolist() == [[298.0, 128.0, 148.0, 208.0]]
  # In the gap the wall passes; frozen, the world holds still.
  s3, _, _, life_lost = one_frame(za, state._replace(
      gap_y=torch.tensor([150.0])), 0, **_NO_SPAWN)
  assert not bool(life_lost) and int(s3.lives) == za.LIVES
  s4, _, _, _ = one_frame(za, s2, 2, **_NO_SPAWN)
  assert float(s4.wall_x) == 398.0 and float(s4.ship_y) == 110.0


def _jitter(rng, x, ulps=2):
  """f32 values within `ulps` ulps of each of x's."""
  x = np.asarray(x, f32)
  for _ in range(ulps):
    step = rng.randint(-1, 2, x.shape)
    x = np.where(step > 0, np.nextafter(x, f32(np.inf)),
                 np.where(step < 0, np.nextafter(x, f32(-np.inf)), x))
  return x.astype(f32)


def _zaxxon_edges(s, rng):
  """The ship within ulps of the gap's edges (gap_y - 18 and + 10 after
  its move) and the wall of the ship's column; the shot within ulps of
  the boxes of two enemies that share one (the first hit dies), of the
  range limit and of the ship's fire; enemies within ulps of the ship's
  box, of the recycle line and of the push line at 120, dead or alive,
  drones and turrets; the freeze on and off; every life count."""
  n = s.lives.shape[0]
  k = za.NUM_ENEMIES
  rows = np.arange(n)
  move = rng.choice(np.asarray([0.0, 2.5, -2.5], f32), n)
  gap_y = rng.uniform(62, 162, n).astype(f32)
  ship_y = np.where(rng.rand(n) < 0.7,
                    _jitter(rng, gap_y + rng.choice([-18.0, 10.0], n)),
                    rng.uniform(44, 180, n).astype(f32)) - move
  wall_x = near(rng, [44.0, 24.0, -4.0, 30.0, 200.0], n)
  ex = rng.uniform(-20, 300, (n, k)).astype(f32)
  ey = rng.uniform(44, 150, (n, k)).astype(f32)
  turret = rng.rand(n, k) < 0.4
  ey = np.where(turret, f32(za.TURRET_Y), ey)
  shared = rng.randint(0, k - 1, n)
  ex[rows, shared + 1] = ex[rows, shared]
  ey[rows, shared + 1] = ey[rows, shared]
  # The shot moves 6 and the enemies 2 before the test.
  shot_x = _jitter(rng, ex[rows, shared] + rng.choice([-14.0, -4.0, 0.0],
                                                      n))
  shot_y = _jitter(rng, ey[rows, shared] + rng.choice([-2.0, 8.0, 3.0], n))
  # Exactly 0 for the fire test's edge: XLA's CPU code reads a subnormal
  # as zero, and no game reaches one.
  shot_x = np.where(rng.rand(n) < 0.2, np.where(
      rng.rand(n) < 0.3, f32(0.0), near(rng, [-1.0, 134.0], n)), shot_x)
  edge = rng.rand(n, k) < 0.4
  ex = np.where(edge, near(rng, [-8.0, 44.0, 20.0, 122.0], n * k)
                .reshape(n, k), ex)
  ey = np.where(edge & (rng.rand(n, k) < 0.5), _jitter(
      rng, ship_y[:, None] + move[:, None] + rng.choice(
          [8.0, -8.0, 0.0], (n, k))), ey)
  return s._replace(
      ship_y=jnp.asarray(np.clip(ship_y, 40.0, 184.0).astype(f32)),
      shot_x=jnp.asarray(shot_x.astype(f32)),
      shot_y=jnp.asarray(shot_y.astype(f32)),
      enemy_x=jnp.asarray(ex.astype(f32)),
      enemy_y=jnp.asarray(ey.astype(f32)), enemy_turret=jnp.asarray(turret),
      enemy_alive=jnp.asarray(rng.rand(n, k) < 0.85),
      wall_x=jnp.asarray(wall_x), gap_y=jnp.asarray(gap_y),
      lives=jnp.asarray(rng.randint(1, za.LIVES + 1, n), jnp.int32),
      freeze=jnp.asarray(rng.choice([0, 0, 0, 1, 9], n), jnp.int32),
      frame=jnp.asarray(rng.choice([10, za.EPISODE_FRAMES - 1], n),
                        jnp.int32))


@pytest.mark.parametrize("name,edit", [("qbert", _qbert_edges),
                                       ("zaxxon", _zaxxon_edges)])
def test_step_on_hand_made_states_matches_jax(name, edit):
  _, reward, _ = step_sweep(name, edit, renders=128)
  assert bool((reward != 0).any())
