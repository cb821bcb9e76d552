"""Differential tests of the port's breakout against the JAX package's (CPU):
the vector env step for step over auto-resets, every output and every state
field exact, frames included; the life-loss rule of tests/test_envs.py on
the port's game; and rainbow/breakout supersteps of both engines from one
JAX state carried across by convert.

Breakout's key advances only on a serve, so the port takes one draw set a
group (`BreakoutStepDraws`); the exactness test serves in most groups, and
JAX's draws come from its key chain (tests/torch_games_jax.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_rainbow import jax_rainbow_draws
from test_torch_slice import _assert_u8_close
from torch_games_jax import jax_env_draws, life_losses_zero_discount
from torch_games_jax import near, run_against_jax, step_sweep

from dqn_zoo_tpu.agents import get_agent as jget_agent
from dqn_zoo_tpu.engine import Engine as JEngine
from dqn_zoo_tpu.envs.api import get_game as jget_game
from dqn_zoo_tpu.engine import EngineConfig as JEngineConfig
from dqn_zoo_tpu.envs.vector import VectorEnvConfig as JEnvConfig
from dqn_zoo_torch import convert
from dqn_zoo_torch.agents import AdamState, get_agent
from dqn_zoo_torch.engine import Engine, EngineConfig
from dqn_zoo_torch.engine.superstep import leaves
from dqn_zoo_torch.envs.api import get_game
from dqn_zoo_torch.envs.games import breakout as bo
from dqn_zoo_torch.envs.vector import VectorEnvConfig
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def tracking_policy(b, seed=0, noise=0.2):
  """FIRE on a dead ball, else the paddle toward the ball; a random action
  in a `noise` share of the envs' steps."""
  rng = np.random.RandomState(seed)

  def policy(step, state):
    del step
    g = state.game_state
    centre = g.paddle_x.numpy() + bo.PADDLE_W / 2
    a = np.where(g.ball_x.numpy() + bo.BALL / 2 > centre, 2, 3)
    a = np.where(g.ball_dead.numpy(), 1, a)
    return np.where(rng.rand(b) < noise, rng.randint(0, 4, b), a)
  return policy


def test_get_game_serves_the_ported_games():
  # All 25 of the JAX package's games, each with JAX's action count.
  for name, actions in (("pong", 6), ("catch", 3), ("seaquest", 18),
                        ("breakout", 4), ("space_invaders", 6),
                        ("freeway", 3), ("asterix", 9), ("atlantis", 4),
                        ("skiing", 3), ("assault", 7), ("beam_rider", 9),
                        ("bowling", 6), ("boxing", 18), ("crazy_climber", 9),
                        ("demon_attack", 6), ("enduro", 9),
                        ("fishing_derby", 18), ("gopher", 8),
                        ("ice_hockey", 18), ("ms_pacman", 9), ("phoenix", 8),
                        ("qbert", 6), ("star_gunner", 18), ("tennis", 18),
                        ("zaxxon", 18)):
    assert get_game(name).num_actions == actions == \
        jget_game(name).num_actions, name
  with pytest.raises(KeyError):
    get_game("pitfall")


def test_vector_breakout_matches_jax_step_for_step():
  b = 8
  seen = dict(bricks=0, serves=0, life_losses=0, game_overs=0)

  def last_life(gs):  # half the envs one life from the end
    return gs._replace(lives=gs.lives.at[: b // 2].set(1))

  def count(before, after, out):
    g0, g1 = before.game_state, after.game_state
    live = ~out.is_first
    seen["bricks"] += int(((out.raw_reward_sum > 0) & live).sum())
    seen["serves"] += int((g0.ball_dead & ~g1.ball_dead & live).sum())
    seen["life_losses"] += int(((g1.lives < g0.lives) & live
                                & ~out.is_last).sum())
    seen["game_overs"] += int((out.is_last & ~out.is_truncated).sum())

  firsts = run_against_jax("breakout", b, 40, tracking_policy(b),
                           prepare=last_life, on_step=count)
  assert firsts > b  # auto-resets after the first groups
  assert all(v > 0 for v in seen.values()), seen


def test_breakout_life_loss_zero_discount():
  # Cut from tests/test_envs.py's 300 random steps to 120 groups of the
  # tracking policy, which serves at once and misses a fifth of the time.
  assert life_losses_zero_discount("breakout", 8, 120, 1,
                                   tracking_policy(8, seed=1, noise=0.5)) > 0


# --- rainbow/breakout supersteps ---------------------------------------------


def _engines(game):
  overrides = dict(target_network_update_period=400)
  jspec = dataclasses.replace(jget_agent("rainbow"), **overrides)
  tspec = dataclasses.replace(get_agent("rainbow"), **overrides)
  # Parity mode as build_engine sets it up for 4 streams, cut to batch 8:
  # two SGD steps a superstep; a 64-frame cap for resets within the run.
  common = dict(game=game, num_envs=4, slots_per_stream=24,
                batch_size=8, learn_every=1, updates_per_learn=2,
                total_train_frames=4_000)
  return (JEngine(JEngineConfig(agent=jspec, env_config=JEnvConfig(
      episode_frame_cap=64), **common)),
          Engine(EngineConfig(agent=tspec, env_config=VectorEnvConfig(
              episode_frame_cap=64), **common), device="cpu"))


def rainbow_supersteps_match_jax(game, supersteps=10):
  """n-step 3 under prioritized replay, two SGD steps a superstep, on
  `game`, at the bounds of test_torch_rainbow.py's catch supersteps: rows,
  the indicator tree, the game state and the frame count exact; frames
  within K2's ±1; the value tree exact at leaves no write touched, written
  ones as priorities within 1e-5; loss rtol 1e-3; parameters within 5e-5
  (rainbow's lr is 6.25e-5, so max(5e-5, lr/2) = 5e-5), 99.9 % of them
  within 2e-6. JAX's engine drops the max-seen priority (see
  test_torch_prioritized.py), so its value tree and max are loaded into the
  port before each superstep. Returns the port's last state and JAX's
  converted."""
  jeng, teng = _engines(game)
  env_draws = lambda env: jax_env_draws(game, env)
  jstate = jax.device_put(jax.device_get(jax.jit(jeng.init)(
      jax.random.PRNGKey(5))))
  tstate = convert.engine_state_from_jax(teng, jax.device_get(jstate))
  jstep = jax.jit(jeng.superstep)
  learned = moved = 0
  for step in range(supersteps):
    jprev = jax.device_get(jstate)
    draws = jax_rainbow_draws(jeng, jprev, env_draws)
    prev = convert.replay_from_jax(jprev.replay, 84, "cpu", prioritized=True)
    before = prev.value_tree[0].clone()
    tstate = tstate._replace(replay=tstate.replay._replace(
        value_tree=prev.value_tree,
        max_seen_priority=prev.max_seen_priority))
    jstate = jstep(jstate)
    tstate = teng.superstep(tstate, draws)
    ref = convert.engine_state_from_jax(teng, jax.device_get(jstate))

    for f in ("stack_count", "action", "reward", "discount", "is_terminal",
              "row_t"):
      assert torch.equal(getattr(tstate.replay, f), getattr(ref.replay, f)), \
          (f, step)
    _assert_u8_close(tstate.replay.frames, ref.replay.frames, step)
    for a, w in zip(tstate.replay.indicator_tree, ref.replay.indicator_tree):
      assert torch.equal(a, w), step
    for name, a, w in zip(ref.env.game_state._fields, tstate.env.game_state,
                          ref.env.game_state):
      assert torch.equal(a, w), (name, step)
    assert tstate.env_frames == ref.env_frames

    got, want = tstate.replay.value_tree[0], ref.replay.value_tree[0]
    untouched = (got == before) & (want == before)
    assert torch.equal(got[untouched], want[untouched]), step
    np.testing.assert_allclose(got.pow(2).numpy(), want.pow(2).numpy(),
                               rtol=0, atol=1e-5, err_msg=str(step))

    assert tstate.telemetry.learn_steps == ref.telemetry.learn_steps
    if ref.telemetry.learn_steps:
      np.testing.assert_allclose(float(tstate.telemetry.last_loss),
                                 float(ref.telemetry.last_loss), rtol=1e-3)
    for tree, ref_tree in ((tstate.online_params, ref.online_params),
                           (tstate.target_params, ref.target_params)):
      diff = torch.cat([(a - w).detach().abs().flatten() for a, w in
                        zip(leaves(tree), leaves(ref_tree))])
      assert float(diff.max()) <= 5e-5, (step, float(diff.max()))
      assert float((diff <= 2e-6).float().mean()) >= 0.999, step
    moved += ref.telemetry.learn_steps > learned
    learned = ref.telemetry.learn_steps
  assert learned >= 4 and moved >= 2
  assert bool(ref.replay.is_terminal.any())  # truncations were inserted
  assert isinstance(tstate.opt_state, AdamState)
  assert int(tstate.opt_state.count) == learned
  return tstate, ref


def test_rainbow_breakout_supersteps_match_jax():
  rainbow_supersteps_match_jax("breakout")


def test_breakout_step_at_cell_edges_matches_jax():
  """The ball held still within 2 ulps of every brick row and column edge
  (by - 56 a multiple of 6, bx - 7 of 8), and of the walls, paddle and
  life-loss line: the step picks the reference's cell, bounce and life
  loss, and the frames agree."""
  def edit(s, rng):
    n = s.lives.shape[0]
    rows = 56.0 + 6.0 * np.arange(-1, 8)
    cols = 7.0 + 8.0 * np.arange(-1, 20)
    return s._replace(
        ball_dead=jnp.zeros(n, bool),
        ball_vx=jnp.zeros(n, jnp.float32), ball_vy=jnp.zeros(n, jnp.float32),
        ball_y=jnp.asarray(near(rng, np.r_[rows, 32.0, 187.0, 205.0], n)),
        ball_x=jnp.asarray(near(rng, np.r_[cols, 8.0, 150.0], n)),
        paddle_x=jnp.asarray(near(rng, np.arange(8.0, 137.0, 1.0), n)),
        bricks=jnp.asarray(rng.rand(n, bo.ROWS, bo.COLS) < 0.7))

  _, reward, _ = step_sweep("breakout", edit)
  assert int((reward > 0).sum()) > 100  # bricks hit at the edges
