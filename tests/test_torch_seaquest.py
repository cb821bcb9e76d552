"""Differential tests of the port's seaquest against the JAX package's (CPU):
the vector env step for step with per-frame draws, every output and every
state field exact, frames included; and the game's rules (shooting scores,
a life loss zeroes the discount, oxygen and surfacing) on the port's game,
as tests/test_envs.py holds them on the JAX one.

JAX splits seaquest's key at init and on every raw frame, the noop burn's
included; `jax_seaquest_env_draws` repeats those splits and hands the port,
frame by frame, the uniforms JAX is about to draw."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dqn_zoo_tpu.envs.api import get_game as jget_game
from dqn_zoo_tpu.envs.vector import VectorAtariEnv as JVectorEnv
from dqn_zoo_tpu.envs.vector import VectorEnvConfig as JEnvConfig
from dqn_zoo_torch import convert
from dqn_zoo_torch.envs.api import get_game
from dqn_zoo_torch.envs.games import seaquest as sq
from dqn_zoo_torch.envs.vector import EnvDraws, VectorAtariEnv
from dqn_zoo_torch.envs.vector import VectorEnvConfig
from torch_games_jax import life_losses_zero_discount, step_sweep
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _spawn_uniforms(key, frames):
  """The spawn uniforms of `frames` raw frames stepped from game key `key`:
  each frame splits the key in three and draws from the second part."""
  out = []
  for _ in range(frames):
    key, k_spawn, _ = jax.random.split(key, 3)
    out.append(jax.random.uniform(k_spawn, (sq.NUM_LANES,)))
  return jnp.stack(out)


def _seaquest_draws(env_key, game_key, max_noops, repeat):
  """One env's draws, as VectorAtariEnv._reset_one, seaquest_init and
  seaquest_step consume them: the reset's noop count, init and burn frames
  from the env key; the group's frames from the game state's key."""
  _, k_init, k_noops = jax.random.split(env_key, 3)
  noops = jax.random.randint(k_noops, (), 1, max_noops + 1)
  key, k_e, k_d = jax.random.split(k_init, 3)
  enemy_x = jax.random.uniform(k_e, (sq.NUM_LANES,), minval=8.0,
                               maxval=140.0)
  diver_u = jax.random.uniform(k_d, (sq.NUM_LANES,))
  return (noops, enemy_x, diver_u, _spawn_uniforms(key, max_noops),
          _spawn_uniforms(game_key, repeat))


@functools.partial(jax.jit, static_argnums=(2, 3))
def _env_draws_jit(env_keys, game_keys, max_noops, repeat):
  return jax.vmap(lambda a, b: _seaquest_draws(a, b, max_noops, repeat))(
      env_keys, game_keys)


def jax_seaquest_env_draws(env_state, max_noops=30, repeat=4) -> EnvDraws:
  """The draws JAX's vector env makes in its next step, per-frame axes
  leading as the port's VectorAtariEnv.draws makes them."""
  noops, enemy_x, diver_u, burn, step = (
      torch.from_numpy(np.array(x)) for x in _env_draws_jit(
          env_state.rng, env_state.game_state.key, max_noops, repeat))
  return EnvDraws(noops=noops,
                  init=sq.SeaquestInitDraws(enemy_x, diver_u),
                  burn=sq.SeaquestStepDraws(burn.transpose(0, 1)),
                  step=sq.SeaquestStepDraws(step.transpose(0, 1)))


def test_vector_seaquest_matches_jax_step_for_step():
  b = 6
  cfg = dict(episode_frame_cap=48)  # truncations and auto-resets within
  jenv = JVectorEnv(jget_game("seaquest"), b, JEnvConfig(**cfg))
  jstate = jenv.init(jax.random.PRNGKey(3))
  tenv = VectorAtariEnv(get_game("seaquest"), b, VectorEnvConfig(**cfg),
                        "cpu")
  # The port's own draws carry the per-frame axes the JAX ones are given in.
  own = tenv.draws(torch.Generator().manual_seed(0))
  assert tuple(own.burn.spawn_u.shape) == (30, b, sq.NUM_LANES)
  assert tuple(own.step.spawn_u.shape) == (4, b, sq.NUM_LANES)
  jstep = jax.jit(jenv.step)
  rng = np.random.RandomState(0)
  eng = type("E", (), {"game": get_game("seaquest")})
  tstate = convert.env_state_from_jax(eng, jax.device_get(jstate), "cpu")
  firsts = spawns = 0
  for step in range(40):
    actions = rng.randint(0, 18, b).astype(np.int32)
    draws = jax_seaquest_env_draws(jax.device_get(jstate))
    prev_divers = tstate.game_state.diver_live
    jstate, jout = jstep(jstate, jnp.asarray(actions))
    tstate, tout = tenv.step(tstate, torch.from_numpy(actions).long(), draws)
    # Every output exactly, frames included (tolerance: none).
    for name, a, w in zip(jout._fields, tout, jout):
      np.testing.assert_array_equal(a.numpy(), np.asarray(w),
                                    err_msg=f"{name} at step {step}")
    ref = convert.env_state_from_jax(eng, jax.device_get(jstate), "cpu")
    for name, a, w in zip(ref.game_state._fields, tstate.game_state,
                          ref.game_state):
      assert a.dtype == w.dtype and torch.equal(a, w), (name, step)
    assert torch.equal(tstate.episode_frames, ref.episode_frames)
    assert torch.equal(tstate.needs_reset, ref.needs_reset)
    firsts += int(tout.is_first.sum())
    spawns += int((tstate.game_state.diver_live & ~prev_divers).sum())
  assert firsts > b  # the run went through auto-resets after the first
  assert spawns > 0  # divers spawned from the per-frame draws


# --- the rules, on the port's game (tests/test_envs.py's, ported) -------------


def _env(b, seed):
  env = VectorAtariEnv(get_game("seaquest"), b, device="cpu")
  gen = torch.Generator().manual_seed(seed)
  return env, gen, env.init(gen)


def test_seaquest_shooting_scores():
  env, gen, state = _env(4, 11)
  # Dive into the lanes then hold DOWNFIRE: torpedoes cross marching sharks.
  for i in range(60):
    a = torch.full((4,), 13 if i < 20 else 1, dtype=torch.int64)
    state, out = env.step(state, a, env.draws(gen))
    if bool((out.raw_reward_sum > 0).any()):
      return
  raise AssertionError("diving + constant FIRE never hit a shark in 60 steps")


def test_seaquest_life_loss_zero_discount():
  # Random play bobs at the surface and loses lives within a few steps.
  assert life_losses_zero_discount("seaquest", 8, 120, 6) > 0, \
      "no life losses observed in 120 steps of random play"


def test_seaquest_oxygen_and_surfacing_rules():
  gen = torch.Generator().manual_seed(0)
  state = sq.seaquest_init(sq.seaquest_init_draws(gen, 1, "cpu"))
  draws = sq.SeaquestStepDraws(torch.ones((1, sq.NUM_LANES)))  # no spawn
  f = lambda v: torch.tensor([v], dtype=torch.float32)
  no = torch.zeros((1,), dtype=torch.bool)
  # Out of air underwater -> life lost, respawned at the surface, full tank.
  state_low = state._replace(player_y=f(120.0), was_surfaced=no,
                             oxygen=f(1.0))
  s2, _, done, life_lost = sq.seaquest_step(state_low, torch.tensor([0]),
                                            draws)
  assert bool(life_lost) and not bool(done)
  assert float(s2.oxygen) == sq.OXYGEN_MAX
  assert float(s2.player_y) == sq.PLAYER_Y0
  # Surfacing with all six divers cashes them in: +50 each, level up.
  state_full = state._replace(
      player_y=f(sq.SURFACE_Y + 2.0), was_surfaced=no,
      divers_held=torch.tensor([sq.MAX_DIVERS], dtype=torch.int32))
  s3, reward, _, _ = sq.seaquest_step(state_full, torch.tensor([2]),  # UP
                                      draws)
  assert float(reward) == sq.DIVER_CASH_POINTS * sq.MAX_DIVERS
  assert int(s3.divers_held) == 0 and int(s3.level) == 1
  # Surfacing empty-handed costs a life.
  state_empty = state._replace(
      player_y=f(sq.SURFACE_Y + 2.0), was_surfaced=no,
      divers_held=torch.zeros((1,), dtype=torch.int32))
  _, _, _, life_lost = sq.seaquest_step(state_empty, torch.tensor([2]),
                                        draws)
  assert bool(life_lost)


def test_seaquest_step_on_hand_made_states_matches_jax():
  """One raw frame of 1,024 states at levels 0-11 (the sharks' speed, one
  multiply-add as XLA compiles it) and every oxygen level (the bar's end,
  a product with 1/6 fused into its sum) through JAX's vmapped step and the
  port's: every output and state field exact, the frames too."""
  def edit(s, rng):
    n = s.level.shape[0]
    return s._replace(
        level=jnp.asarray(rng.randint(0, 12, n), jnp.int32),
        oxygen=jnp.asarray(rng.randint(0, 361, n), jnp.float32),
        enemy_x=jnp.asarray(rng.uniform(-20.0, 170.0, (n, sq.NUM_LANES)),
                            jnp.float32))

  step_sweep("seaquest", edit)
