"""iqn/ms_pacman on the CPU: supersteps of the port's engine and of the JAX
package's from one JAX state carried across by convert, past the min fill
through learn steps and a target swap, and the iqn runner on ms_pacman.
Ms_pacman has 9 actions, so the IQN head's output is 9 wide; its step
draws come from JAX's key chain (tests/torch_games_jax.py)."""

import csv
import dataclasses

import jax
import numpy as np
import torch

from test_torch_iqn import _act_draws
from test_torch_iqn_learn import _loss_taus
from test_torch_slice import _assert_u8_close
from torch_games_jax import jax_env_draws

from dqn_zoo_tpu.agents import get_agent as jget_agent
from dqn_zoo_tpu.engine import Engine as JEngine
from dqn_zoo_tpu.engine import EngineConfig as JEngineConfig
from dqn_zoo_tpu.envs.vector import VectorEnvConfig as JEnvConfig
from dqn_zoo_torch import convert
from dqn_zoo_torch.agents import AdamState, get_agent
from dqn_zoo_torch.engine import Engine, EngineConfig, SuperstepDraws
from dqn_zoo_torch.engine.superstep import leaves
from dqn_zoo_torch.envs.games import ms_pacman as mp
from dqn_zoo_torch.envs.vector import VectorEnvConfig
from dqn_zoo_torch.run.agents import run_agent
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _engines():
  # 8 taus of each kind keep the test small; learning starts at 3 % of the
  # 64 rows.
  overrides = dict(tau_samples_policy=8, tau_samples_s_tm1=8,
                   tau_samples_s_t=8, min_replay_capacity_fraction=0.05,
                   target_network_update_period=48)
  jspec = dataclasses.replace(jget_agent("iqn"), **overrides)
  tspec = dataclasses.replace(get_agent("iqn"), **overrides)
  common = dict(game="ms_pacman", num_envs=4, slots_per_stream=16,
                batch_size=8, learn_every=1, updates_per_learn=1,
                total_train_frames=20_000)
  return (JEngine(JEngineConfig(agent=jspec, env_config=JEnvConfig(
      episode_frame_cap=36), **common)),
          Engine(EngineConfig(agent=tspec, env_config=VectorEnvConfig(
              episode_frame_cap=36), **common), device="cpu"))


def _learn_draws(jeng, js) -> SuperstepDraws:
  """The draws JAX's Engine.superstep makes from js.rng for an iqn
  superstep on ms_pacman: iqn_act's (9 actions), the replay sample's and
  iqn_loss's."""
  cfg, spec = jeng.config, jeng.spec
  _, act_key, learn_key = jax.random.split(js.rng, 3)
  explore_u, random_action, act_taus = _act_draws(
      act_key, cfg.num_envs, spec.tau_samples_policy,
      num_actions=mp.GAME.num_actions)
  sample_key, loss_key = jax.random.split(learn_key)
  u_key = jax.random.split(sample_key, 3)[0]
  sample_u = torch.from_numpy(np.array(jax.random.uniform(
      u_key, (cfg.batch_size,))))[None]
  loss_taus = tuple(x[None] for x in _loss_taus(
      loss_key, cfg.batch_size, spec.tau_samples_s_tm1))
  return SuperstepDraws(explore_u, random_action, sample_u,
                        jax_env_draws("ms_pacman", js.env), act_taus,
                        loss_taus)


def test_iqn_ms_pacman_supersteps_match_jax():
  """Bounds as the iqn/pong learning supersteps': rows exact, frames
  within K2's ±1, loss rtol 1e-3, parameters and Adam's moments rtol 1e-4
  and atol 1e-6."""
  jeng, teng = _engines()
  jstate = jax.device_put(jax.device_get(jax.jit(jeng.init)(
      jax.random.PRNGKey(5))))
  tstate = convert.engine_state_from_jax(teng, jax.device_get(jstate))
  jstep = jax.jit(jeng.superstep)
  swaps = 0
  for step in range(10):
    draws = _learn_draws(jeng, jax.device_get(jstate))
    prev_target = [p.clone() for p in leaves(tstate.target_params)]
    jstate = jstep(jstate)
    tstate = teng.superstep(tstate, draws)
    ref = convert.engine_state_from_jax(teng, jax.device_get(jstate))

    for f in ("stack_count", "action", "reward", "discount", "is_terminal",
              "row_t"):
      assert torch.equal(getattr(tstate.replay, f), getattr(ref.replay, f)), \
          (f, step)
    _assert_u8_close(tstate.replay.frames, ref.replay.frames, step)
    for field, a, w in zip(ref.env.game_state._fields,
                           tstate.env.game_state, ref.env.game_state):
      assert torch.equal(a, w), (field, step)
    assert tstate.env_frames == ref.env_frames
    assert tstate.telemetry.learn_steps == ref.telemetry.learn_steps
    if ref.telemetry.learn_steps:
      np.testing.assert_allclose(float(tstate.telemetry.last_loss),
                                 float(ref.telemetry.last_loss), rtol=1e-3)
    for tree, ref_tree in ((tstate.online_params, ref.online_params),
                           (tstate.target_params, ref.target_params)):
      for a, w in zip(leaves(tree), leaves(ref_tree)):
        np.testing.assert_allclose(a.detach().numpy(), w.detach().numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=str(step))
    assert isinstance(tstate.opt_state, AdamState)
    assert int(tstate.opt_state.count) == ref.telemetry.learn_steps
    for a, w in zip(tstate.opt_state.mu + tstate.opt_state.nu,
                    ref.opt_state.mu + ref.opt_state.nu):
      np.testing.assert_allclose(a.numpy(), w.numpy(), rtol=1e-4, atol=1e-6,
                                 err_msg=str(step))
    swaps += any(not torch.equal(a, b) for a, b in
                 zip(prev_target, leaves(tstate.target_params)))
  assert ref.telemetry.learn_steps >= 4 and swaps >= 1
  assert tstate.online_params["head"]["out"]["w"].shape[-1] == 9
  assert np.isfinite(float(tstate.telemetry.last_loss))


def test_iqn_runner_takes_ms_pacman(tmp_path):
  path = tmp_path / "r.csv"
  run_agent("iqn", ["--device=cpu", "--environment_name=ms_pacman",
                    "--num_envs=2", "--replay_capacity=64",
                    "--batch_size=4", "--tau_samples_policy=4",
                    "--num_iterations=1", "--num_train_frames=16",
                    "--num_eval_frames=8", "--max_frames_per_episode=16",
                    f"--results_csv_path={path}"])
  rows = list(csv.DictReader(open(path)))
  assert [int(r["iteration"]) for r in rows] == [0, 1]
  assert rows[1]["train_state_value"] != "nan"
