"""Differential tests of slice A as a whole: pong and the vector env, then
several supersteps of the JAX engine and the port's engine from one JAX
state carried across by dqn_zoo_torch.convert (CPU).

JAX draws its random numbers from keys carried in its state; the port takes
them as inputs. `jax_draws` repeats JAX's key splits on the JAX state before
a superstep and hands the port exactly the values JAX is about to draw.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dqn_zoo_tpu.agents import get_agent as jget_agent
from dqn_zoo_tpu.engine import Engine as JEngine
from dqn_zoo_tpu.engine import EngineConfig as JEngineConfig
from dqn_zoo_tpu.envs.api import get_game as jget_game
from dqn_zoo_tpu.envs.games import pong as jpong
from dqn_zoo_tpu.envs.vector import VectorAtariEnv as JVectorEnv
from dqn_zoo_tpu.envs.vector import VectorEnvConfig as JEnvConfig
from dqn_zoo_torch import convert
from dqn_zoo_torch.agents import get_agent
from dqn_zoo_torch.engine import Engine, EngineConfig, SuperstepDraws
from dqn_zoo_torch.engine.superstep import leaves
from dqn_zoo_torch.envs.games.pong import PongInitDraws, PongStepDraws
from dqn_zoo_torch.envs.vector import EnvDraws, VectorEnvConfig
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _pong_draws(env_key, game_key, max_noops):
  """One env's reset and step draws, as VectorAtariEnv._reset_one,
  pong_init and pong._serve consume them."""
  _, k_init, k_noops = jax.random.split(env_key, 3)
  noops = jax.random.randint(k_noops, (), 1, max_noops + 1)
  key, k1, k2, k3 = jax.random.split(k_init, 4)
  toward = jax.random.bernoulli(k1)
  key, kv = jax.random.split(key)
  vy = jax.random.uniform(kv, (), minval=-2.0, maxval=2.0)
  ball_y = jax.random.uniform(k2, (), minval=float(jpong.TOP) + 20.0,
                              maxval=float(jpong.BOTTOM) - 24.0)
  delay = jax.random.randint(k3, (), 2, 12)
  # A serve during the noop burn splits the key pong_init returned; a serve
  # during the group splits the game state's current key.
  burn_vy = jax.random.uniform(jax.random.split(key)[1], (),
                               minval=-2.0, maxval=2.0)
  step_vy = jax.random.uniform(jax.random.split(game_key)[1], (),
                               minval=-2.0, maxval=2.0)
  return noops, toward, vy, ball_y, delay, burn_vy, step_vy


@functools.partial(jax.jit, static_argnums=2)
def _env_draws_jit(env_keys, game_keys, max_noops):
  return jax.vmap(lambda a, b: _pong_draws(a, b, max_noops))(env_keys,
                                                            game_keys)


def jax_env_draws(env_state, max_noops=30) -> EnvDraws:
  d = [torch.from_numpy(np.array(x)) for x in _env_draws_jit(
      env_state.rng, env_state.game_state.key, max_noops)]
  noops, toward, vy, ball_y, delay, burn_vy, step_vy = d
  return EnvDraws(noops=noops,
                  init=PongInitDraws(toward, vy, ball_y, delay),
                  burn=PongStepDraws(burn_vy),
                  step=PongStepDraws(step_vy))


def jax_draws(jeng, jstate) -> SuperstepDraws:
  """The draws JAX's Engine.superstep makes from jstate.rng."""
  cfg = jeng.config
  _, act_key, learn_key = jax.random.split(jstate.rng, 3)
  _, policy_key = jax.random.split(act_key)
  explore_key, uniform_key = jax.random.split(policy_key)
  b = cfg.num_envs
  random_action = jax.random.randint(uniform_key, (b,), 0,
                                     jeng.game.num_actions)
  explore_u = jax.random.uniform(explore_key, (b,))
  keys = ([learn_key] if cfg.updates_per_learn == 1
          else jax.random.split(learn_key, cfg.updates_per_learn))
  sample_u = []
  for k in keys:
    sample_key = jax.random.split(k)[0]
    u_key = jax.random.split(sample_key, 3)[0]
    sample_u.append(np.asarray(jax.random.uniform(u_key, (cfg.batch_size,))))
  t = lambda x: torch.from_numpy(np.array(x))
  return SuperstepDraws(t(explore_u), t(random_action), t(np.stack(sample_u)),
                        jax_env_draws(jstate.env, cfg.env_config.max_noops))


def _assert_u8_close(a, b, what):
  """Observations: the port's resize sums in another order than
  jax.image.resize, so a pixel may differ by 1 (the K2 tolerance)."""
  diff = np.abs(np.asarray(a).astype(int) - np.asarray(b).astype(int))
  assert diff.max() <= 1, what
  assert (diff == 0).mean() > 0.98, what


# --- pong + vector env --------------------------------------------------------


def test_vector_pong_matches_jax_step_for_step():
  b = 6
  cfg = dict(episode_frame_cap=48)  # truncations and auto-resets within
  jenv = JVectorEnv(jget_game("pong"), b, JEnvConfig(**cfg))
  jstate = jenv.init(jax.random.PRNGKey(3))
  from dqn_zoo_torch.envs.api import get_game
  from dqn_zoo_torch.envs.vector import VectorAtariEnv
  tenv = VectorAtariEnv(get_game("pong"), b, VectorEnvConfig(**cfg), "cpu")
  jstep = jax.jit(jenv.step)
  rng = np.random.RandomState(0)
  eng = type("E", (), {"game": get_game("pong")})
  tstate = convert.env_state_from_jax(eng, jax.device_get(jstate), "cpu")
  firsts = 0
  for step in range(40):
    actions = rng.randint(0, 6, b).astype(np.int32)
    draws = jax_env_draws(jax.device_get(jstate))
    jstate, jout = jstep(jstate, jnp.asarray(actions))
    tstate, tout = tenv.step(tstate, torch.from_numpy(actions).long(), draws)
    for name, a, w in zip(jout._fields, tout, jout):
      np.testing.assert_array_equal(a.numpy(), np.asarray(w),
                                    err_msg=f"{name} at step {step}")
    ref = convert.env_state_from_jax(eng, jax.device_get(jstate), "cpu")
    for name, a, w in zip(ref.game_state._fields, tstate.game_state,
                          ref.game_state):
      assert torch.equal(a, w), (name, step)
    assert torch.equal(tstate.episode_frames, ref.episode_frames)
    assert torch.equal(tstate.needs_reset, ref.needs_reset)
    firsts += int(tout.is_first.sum())
  assert firsts > b  # the run went through auto-resets after the first


# --- the slice: several supersteps of both engines ------------------------------


def _engines(num_envs=4, overlap_env_learn=False, compute_dtype="float32"):
  overrides = dict(target_network_update_period=48,
                   compute_dtype=compute_dtype)
  jspec = dataclasses.replace(jget_agent("dqn"), **overrides)
  tspec = dataclasses.replace(get_agent("dqn"), **overrides)
  common = dict(game="pong", num_envs=num_envs, slots_per_stream=16,
                batch_size=8, learn_every=1, updates_per_learn=1,
                total_train_frames=20_000,
                overlap_env_learn=overlap_env_learn)
  jeng = JEngine(JEngineConfig(agent=jspec, env_config=JEnvConfig(
      episode_frame_cap=36), **common))
  teng = Engine(EngineConfig(agent=tspec, env_config=VectorEnvConfig(
      episode_frame_cap=36), **common), device="cpu")
  return jeng, teng


def test_whole_slice_supersteps_match_jax():
  jeng, teng = _engines()
  jstate = jeng.init(jax.random.PRNGKey(0))
  tstate = convert.engine_state_from_jax(teng, jax.device_get(jstate))
  jstep = jax.jit(jeng.superstep)
  learned = swaps = 0
  for step in range(16):
    draws = jax_draws(jeng, jax.device_get(jstate))
    prev_target = [p.clone() for p in leaves(tstate.target_params)]
    jstate = jstep(jstate)
    tstate = teng.superstep(tstate, draws)
    ref = convert.engine_state_from_jax(teng, jax.device_get(jstate))

    # Actions and every replay row field: exact (frames within K2's ±1).
    for f in ("stack_count", "action", "reward", "discount", "is_terminal",
              "row_t"):
      assert torch.equal(getattr(tstate.replay, f), getattr(ref.replay, f)), \
          (f, step)
    _assert_u8_close(tstate.replay.frames, ref.replay.frames, step)
    assert torch.equal(tstate.replay.indicator_tree[0],
                       ref.replay.indicator_tree[0])
    _assert_u8_close(tstate.stack.frames, ref.stack.frames, step)
    for name, a, w in zip(ref.env.game_state._fields, tstate.env.game_state,
                          ref.env.game_state):
      assert torch.equal(a, w), (name, step)
    assert tstate.env_frames == ref.env_frames

    # Loss and parameters: f32 on both sides, with the few ±1 observation
    # pixels feeding the nets. RMSProp's step saturates at lr·4.6 ≈ 1.2e-3
    # for large gradients and is steepest for gradients near sqrt(eps/0.05),
    # where a gradient moved 1e-4 relative by those pixels moves a weight by
    # up to ~1e-5; nearly every weight agrees to 2e-6.
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
    np.testing.assert_allclose(float(tstate.telemetry.state_value_ewma),
                               float(ref.telemetry.state_value_ewma),
                               rtol=1e-4, atol=1e-9)
    learned = ref.telemetry.learn_steps
    swaps += any(not torch.equal(a, b) for a, b in
                 zip(prev_target, leaves(tstate.target_params)))
  assert learned >= 5 and swaps >= 1
  assert bool(ref.replay.is_terminal.any())  # truncations were inserted


def test_eval_supersteps_match_jax():
  jeng, teng = _engines(num_envs=3)
  jstate = jeng.init(jax.random.PRNGKey(1))
  params = jax.device_get(jstate.online_params)
  tparams = convert.params_from_jax(params, "cpu")
  jeval = jeng.eval_init(jax.random.PRNGKey(2), num_envs=3)
  teval = teng.eval_init(0, num_envs=3)
  eng = type("E", (), {"game": teng.game})
  teval = teval._replace(env=convert.env_state_from_jax(
      eng, jax.device_get(jeval.env), "cpu"))
  jstep = jax.jit(jeng.eval_superstep)
  for _ in range(12):
    je = jax.device_get(jeval)
    _, act_key = jax.random.split(je.rng)
    _, policy_key = jax.random.split(act_key)
    explore_key, uniform_key = jax.random.split(policy_key)
    t = lambda x: torch.from_numpy(np.array(x))
    draws = SuperstepDraws(
        t(jax.random.uniform(explore_key, (3,))),
        t(jax.random.randint(uniform_key, (3,), 0, 6)), None,
        jax_env_draws(je.env))
    jeval = jstep(params, jeval)
    teval = teng.eval_superstep(tparams, teval, draws)
    _assert_u8_close(teval.stack.frames, np.asarray(jeval.stack.frames),
                     "eval stack")
    assert int(teval.env_frames) == int(jeval.env_frames)
    np.testing.assert_array_equal(teval.episode_return.numpy(),
                                  np.asarray(jeval.episode_return))
    assert float(teval.completed_count) == float(jeval.completed_count)


def test_modes_not_ported_yet_raise():
  spec = get_agent("dqn")
  base = dict(agent=spec, game="pong", num_envs=2, slots_per_stream=16)
  # bf16 compute is ported: the config and its engine build, with the cast
  # torso; a dtype name the JAX CLI does not name raises.
  eng = Engine(EngineConfig(**{**base, "agent": dataclasses.replace(
      spec, compute_dtype="bfloat16")}), device="cpu")
  assert eng.network.compute_dtype == torch.bfloat16
  with pytest.raises(ValueError, match="compute_dtype"):
    EngineConfig(**{**base, "agent": dataclasses.replace(
        spec, compute_dtype="float16")})
  # Data parallelism is ported: the config builds, and its engine needs a
  # process group (parallel.init_distributed).
  cfg = EngineConfig(**base, pmap_axis="d", frame_multiplier=2)
  assert cfg.frame_multiplier == 2
  with pytest.raises(RuntimeError, match="process group"):
    Engine(cfg, device="cpu")
  # Overlap mode and the host env's action count are ported.
  eng = Engine(EngineConfig(**base, overlap_env_learn=True), device="cpu")
  assert eng.config.overlap_env_learn and eng.num_actions == 6
  eng = Engine(EngineConfig(**{**base, "game": "krull"}, num_actions=4),
               device="cpu")
  assert eng.game is None and eng.env is None and eng.num_actions == 4
  assert eng.init(0).env is None
  with pytest.raises(KeyError, match="ALE backend"):
    Engine(EngineConfig(**{**base, "game": "krull"}), device="cpu")
