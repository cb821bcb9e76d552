"""Differential test of the port's catch against the JAX package's (CPU): the
vector env step for step, rewards, dones and the 210×160 RGB frames exact.

JAX draws catch's ball column and paddle start from the key of each env's
reset; `jax_catch_env_draws` repeats those splits and hands the port the
same values."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dqn_zoo_tpu.envs.api import get_game as jget_game
from dqn_zoo_tpu.envs.games import catch as jcatch
from dqn_zoo_tpu.envs.vector import VectorAtariEnv as JVectorEnv
from dqn_zoo_tpu.envs.vector import VectorEnvConfig as JEnvConfig
from dqn_zoo_torch import convert
from dqn_zoo_torch.envs.api import get_game
from dqn_zoo_torch.envs.games.catch import CatchInitDraws
from dqn_zoo_torch.envs.vector import EnvDraws, VectorAtariEnv
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _catch_draws(env_key, max_noops):
  """One env's reset draws, as VectorAtariEnv._reset_one and catch_init
  consume them."""
  _, k_init, k_noops = jax.random.split(env_key, 3)
  noops = jax.random.randint(k_noops, (), 1, max_noops + 1)
  _, k1, k2 = jax.random.split(k_init, 3)
  ball_col = jax.random.randint(k1, (), 0, jcatch.COLS)
  paddle_pos = jax.random.randint(k2, (), 0, jcatch.COLS)
  return noops, ball_col, paddle_pos


@functools.partial(jax.jit, static_argnums=1)
def _env_draws_jit(env_keys, max_noops):
  return jax.vmap(lambda k: _catch_draws(k, max_noops))(env_keys)


def jax_catch_env_draws(env_state, max_noops=30) -> EnvDraws:
  noops, col, paddle = (torch.from_numpy(np.array(x)) for x in
                        _env_draws_jit(env_state.rng, max_noops))
  return EnvDraws(noops=noops, init=CatchInitDraws(col, paddle), burn=None,
                  step=None)


def test_vector_catch_matches_jax_step_for_step():
  b = 4
  jenv = JVectorEnv(jget_game("catch"), b, JEnvConfig())
  jstate = jenv.init(jax.random.PRNGKey(5))
  tenv = VectorAtariEnv(get_game("catch"), b, device="cpu")
  jstep = jax.jit(jenv.step)
  rng = np.random.RandomState(1)
  eng = type("E", (), {"game": get_game("catch")})
  tstate = convert.env_state_from_jax(eng, jax.device_get(jstate), "cpu")
  ends = np.zeros(b, np.int64)
  rewards = []
  for step in range(70):
    actions = rng.randint(0, 3, b).astype(np.int32)
    draws = jax_catch_env_draws(jax.device_get(jstate))
    jstate, jout = jstep(jstate, jnp.asarray(actions))
    tstate, tout = tenv.step(tstate, torch.from_numpy(actions).long(), draws)
    # Every output exactly, frames included (tolerance: none).
    for name, a, w in zip(jout._fields, tout, jout):
      np.testing.assert_array_equal(a.numpy(), np.asarray(w),
                                    err_msg=f"{name} at step {step}")
    ref = convert.env_state_from_jax(eng, jax.device_get(jstate), "cpu")
    for name, a, w in zip(ref.game_state._fields, tstate.game_state,
                          ref.game_state):
      assert torch.equal(a, w), (name, step)
    assert torch.equal(tstate.episode_frames, ref.episode_frames)
    assert torch.equal(tstate.needs_reset, ref.needs_reset)
    ends += tout.is_last.numpy()
    rewards += tout.reward_sum[tout.is_last].tolist()
  assert (ends >= 2).all(), ends  # every env finished two episodes or more
  assert set(rewards) == {-1.0, 1.0}, rewards  # catches and misses
