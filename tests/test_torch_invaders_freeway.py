"""Differential tests of the port's space_invaders and freeway against the
JAX package's (CPU): the vector env step for step over auto-resets, every
output and every state field exact, frames included; and the games' rules
of tests/test_envs.py on the port's games.

Space Invaders splits its key on every raw frame (a column and a spawn test
for each bomb slot), so it takes per-frame draws; freeway draws only at
init. JAX's draws come from its key chain (tests/torch_games_jax.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_games_jax import life_losses_zero_discount, near, random_policy
from torch_games_jax import run_against_jax, step_sweep

from dqn_zoo_torch.envs.api import get_game
from dqn_zoo_torch.envs.games import freeway as fw
from dqn_zoo_torch.envs.games import space_invaders as si
from dqn_zoo_torch.envs.vector import VectorAtariEnv
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _up_policy(b, seed=0):
  """UP in 85 % of the envs' steps, else a random action."""
  rng = np.random.RandomState(seed)
  return lambda step, state: np.where(rng.rand(b) < 0.85, 1,
                                      rng.randint(0, 3, b))


def _invaders_end(gs):
  # Half the envs on their last life; the wave one row above the cannon.
  b = gs.lives.shape[0]
  return gs._replace(lives=gs.lives.at[: b // 2].set(1),
                     grid_y=gs.grid_y.at[b // 2:].set(92.0))


def _freeway_end(gs):
  # Half the envs 40 frames from the end of the clock.
  b = gs.frame.shape[0]
  return gs._replace(frame=gs.frame.at[: b // 2].set(fw.EPISODE_FRAMES - 40))


@pytest.mark.parametrize("name", ["space_invaders", "freeway"])
def test_vector_env_matches_jax_step_for_step(name):
  b = 8
  seen = dict(rewards=0, game_overs=0, events=0)

  def count(before, after, out):
    live = ~out.is_first
    g0, g1 = before.game_state, after.game_state
    seen["rewards"] += int(((out.raw_reward_sum > 0) & live).sum())
    seen["game_overs"] += int((out.is_last & ~out.is_truncated).sum())
    if name == "space_invaders":  # bombs spawned from the per-frame draws
      seen["events"] += int((g1.bomb_live & ~g0.bomb_live).sum())
    else:  # knocked back by a car
      seen["events"] += int(((g1.chicken_y > g0.chicken_y) & live).sum())

  policy = (random_policy(name, b) if name == "space_invaders"
            else _up_policy(b))
  prepare = _invaders_end if name == "space_invaders" else _freeway_end
  firsts = run_against_jax(name, b, 40, policy, prepare=prepare,
                           on_step=count)
  assert firsts > b  # auto-resets after the first groups
  assert all(v > 0 for v in seen.values()), seen


def _env(name, b, seed):
  env = VectorAtariEnv(get_game(name), b, device="cpu")
  gen = torch.Generator().manual_seed(seed)
  return env, gen, env.init(gen)


def test_space_invaders_shooting_scores():
  env, gen, state = _env("space_invaders", 4, 2)
  fire = torch.ones((4,), dtype=torch.int64)  # FIRE every agent-step
  for _ in range(40):
    state, out = env.step(state, fire, env.draws(gen))
    if bool((out.raw_reward_sum > 0).any()):
      return
  raise AssertionError("constant FIRE never hit an alien in 40 agent-steps")


def test_space_invaders_life_loss_zero_discount():
  # tests/test_envs.py rolls 400 random steps; 100 see 17 life losses.
  assert life_losses_zero_discount("space_invaders", 8, 100, 4) > 0


def test_freeway_crossing_rewards():
  # tests/test_envs.py's horizon of 100 agent-steps, both policies.
  env, gen, state = _env("freeway", 4, 0)
  up = torch.ones((4,), dtype=torch.int64)
  total = np.zeros(4)
  for _ in range(100):
    state, out = env.step(state, up, env.draws(gen))
    total += out.raw_reward_sum.numpy()
  assert (total >= 1).all(), f"always-UP failed to cross: {total}"
  env, gen, state = _env("freeway", 4, 9)
  rng = np.random.RandomState(9)
  rnd = np.zeros(4)
  for _ in range(100):
    a = torch.from_numpy(rng.randint(0, 3, 4)).long()
    state, out = env.step(state, a, env.draws(gen))
    rnd += out.raw_reward_sum.numpy()
  assert rnd.mean() < total.mean()


def test_freeway_timed_termination():
  gen = torch.Generator().manual_seed(0)
  state = fw.freeway_init(fw.freeway_init_draws(gen, 1, "cpu"))
  state = state._replace(frame=torch.tensor([fw.EPISODE_FRAMES - 1],
                                            dtype=torch.int32))
  _, _, done, life_lost = fw.freeway_step(state, torch.tensor([0]))
  assert bool(done) and not bool(life_lost)


def test_space_invaders_bomb_draws_are_per_frame():
  env = VectorAtariEnv(get_game("space_invaders"), 3, device="cpu")
  draws = env.draws(torch.Generator().manual_seed(0))
  assert tuple(draws.burn.spawn_u.shape) == (30, 3, si.NUM_BOMBS)
  assert tuple(draws.step.spawn_col.shape) == (4, 3, si.NUM_BOMBS)
  assert int(draws.step.spawn_col.max()) < si.COLS


def test_space_invaders_step_at_cell_edges_matches_jax():
  """Every alien count and waves 0-9 (the march speed's multiply-adds), and
  a live shot within 2 ulps of the row and column edges of the grid: the
  step marches, hits and scores as the reference, and the frames agree."""
  def edit(s, rng):
    n = s.lives.shape[0]
    gx = rng.uniform(20.0, 60.0, n).astype(np.float32)
    gy = rng.uniform(40.0, 80.0, n).astype(np.float32)
    alive = rng.rand(n, si.ROWS, si.COLS) < rng.rand(n, 1, 1)
    # The shot moves up SHOT_SPEED before the lookup.
    rel_y = near(rng, si.SPACING_Y * np.arange(-1.0, 7.0), n)
    rel_x = near(rng, si.SPACING_X * np.arange(-1.0, 7.0), n)
    return s._replace(
        aliens=jnp.asarray(alive), wave=jnp.asarray(rng.randint(0, 10, n)),
        grid_x=jnp.asarray(gx), grid_y=jnp.asarray(gy),
        direction=jnp.asarray(np.where(rng.rand(n) < 0.5, 1.0, -1.0)
                              .astype(np.float32)),
        shot_live=jnp.ones(n, bool),
        shot_x=jnp.asarray(gx + rel_x), shot_y=jnp.asarray(
            gy + rel_y + np.float32(si.SHOT_SPEED)))

  state, reward, _ = step_sweep("space_invaders", edit)
  assert int((reward > 0).sum()) > 50
