"""Differential tests of the port's host env path (CPU): the farm built from
cpp/dz_env.cc against the JAX package's bridge, bit for bit; the port's
HostEnvEngine against JAX's over the same farm outputs, with the draws
JAX's host step takes from its key chain; an ALE-only cartridge (a mock
libale) trained through the port's host engine.
"""

import dataclasses
import os
import shutil
import subprocess
import types

import jax
import numpy as np
import pytest
import torch

from test_torch_iqn import _act_draws, _t
from test_torch_iqn_learn import _loss_taus

from dqn_zoo_tpu.agents import get_agent as jget_agent
from dqn_zoo_tpu.engine import EngineConfig as JEngineConfig
from dqn_zoo_tpu.engine.host_env import HostEnvEngine as JHostEnvEngine
from dqn_zoo_tpu.envs.cpp_bridge import CppVectorEnv as JCppVectorEnv
from dqn_zoo_tpu.envs.vector import VectorEnvConfig as JEnvConfig
from dqn_zoo_torch import convert
from dqn_zoo_torch.agents import get_agent
from dqn_zoo_torch.engine import EngineConfig, SuperstepDraws
from dqn_zoo_torch.engine.host_env import HostEnvEngine
from dqn_zoo_torch.engine.superstep import leaves
from dqn_zoo_torch.envs import api, cpp_bridge
from dqn_zoo_torch.envs.cpp_bridge import CppVectorEnv
from dqn_zoo_torch.envs.vector import VectorEnvConfig
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _host_fields_equal(got, want, what):
  for name, a, w in zip(want._fields, got, want):
    assert a.dtype == w.dtype, (what, name)
    np.testing.assert_array_equal(a, w, err_msg=f"{what}: {name}")


# --- the farm ----------------------------------------------------------------------


@pytest.mark.parametrize("game", ["pong", "breakout", "catch", "seaquest"])
def test_farm_matches_the_jax_bridge_bit_for_bit(game):
  b = 8
  port = CppVectorEnv(game, b, seed=3, num_threads=4, device="cpu")
  ref = JCppVectorEnv(game, b, seed=3, num_threads=4)
  assert port.num_actions == ref.num_actions
  assert cpp_bridge.library_path().parent == cpp_bridge.BUILD_DIR
  rng = np.random.RandomState(5)
  firsts = life_losses = 0
  lives = None
  for step in range(40):
    actions = rng.randint(0, port.num_actions, b).astype(np.int32)
    got, want = port.step(actions), ref.step(actions)
    _host_fields_equal(got, want, f"{game} group {step}")
    dev = port.upload(got)
    for name in ("obs84", "reward_sum", "discount_prod", "is_first",
                 "is_last", "frames_used"):
      np.testing.assert_array_equal(getattr(dev, name).numpy(),
                                    getattr(got, name), err_msg=name)
    if lives is not None:
      lost = ~got.is_first & (got.lives < lives) & (got.lives > 0)
      assert (got.discount_prod[lost] == 0.0).all()
      life_losses += int(lost.sum())
    lives = got.lives
    firsts += int(got.is_first.sum())
  assert firsts >= b
  if game == "breakout":  # the life-loss discount was exercised
    assert life_losses > 0
  port.close()
  ref.close()


def test_farm_truncates_at_the_frame_cap_as_the_jax_bridge():
  port = CppVectorEnv("pong", 2, seed=0, num_threads=1,
                      episode_frame_cap=40, device="cpu")
  ref = JCppVectorEnv("pong", 2, seed=0, num_threads=1, episode_frame_cap=40)
  truncated = 0
  for step in range(24):
    actions = np.full((2,), step % 6, np.int32)
    got, want = port.step(actions), ref.step(actions)
    _host_fields_equal(got, want, f"group {step}")
    assert (got.is_last[got.is_truncated]).all()
    assert (got.discount_prod[got.is_truncated] == 1.0).all()
    truncated += int(got.is_truncated.sum())
  assert truncated >= 2


def test_farm_refuses_what_it_cannot_take(monkeypatch):
  with pytest.raises(ValueError, match="unknown game 'krull'"):
    CppVectorEnv("krull", 2, device="cpu")
  env = CppVectorEnv("catch", 2, device="cpu")
  with pytest.raises(ValueError, match="shape"):
    env.step(np.zeros((3,), np.int32))
  group = env.step(np.zeros((2,), np.int32))
  with pytest.raises(ValueError, match="step returned"):
    env.upload(group._replace(obs84=group.obs84.copy()))
  env.close()
  # No compiler: an error, never the committed cpp/libdz_env.so.
  monkeypatch.setattr(shutil, "which", lambda name: None)
  with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
    cpp_bridge.find_cxx()


def test_farm_library_is_built_outside_cpp_and_dz_env_lib_selects(
    monkeypatch, tmp_path):
  monkeypatch.delenv("DZ_ENV_LIB", raising=False)
  built = cpp_bridge.library_path()
  assert built.parent == cpp_bridge.BUILD_DIR
  assert built.exists() and built.name.startswith("libdz_env_")
  assert cpp_bridge.CPP_DIR not in built.parents
  # Another build: a name relative to cpp/, or an absolute path.
  monkeypatch.setenv("DZ_ENV_LIB", "libdz_env.so")
  assert cpp_bridge.library_path() == cpp_bridge.CPP_DIR / "libdz_env.so"
  monkeypatch.setenv("DZ_ENV_LIB", str(tmp_path / "missing.so"))
  with pytest.raises(FileNotFoundError, match="missing.so"):
    cpp_bridge.library_path()
  copy = tmp_path / "copy.so"
  shutil.copy(built, copy)
  monkeypatch.setenv("DZ_ENV_LIB", str(copy))
  assert cpp_bridge.library_path() == copy
  assert CppVectorEnv("pong", 2, device="cpu").num_actions == 6


def test_get_game_points_ale_only_cartridges_at_the_farm():
  with pytest.raises(KeyError, match="ALE backend"):
    api.get_game("krull")
  with pytest.raises(KeyError, match="Unknown game"):
    api.get_game("not_a_cartridge")


# --- the host engine against JAX's ---------------------------------------------------


def jax_host_draws(jeng, tspec, js) -> SuperstepDraws:
  """The draws JAX's host half-step makes from js.rng. Unlike the fused
  engine, it always splits its learn key into `updates_per_learn` keys."""
  cfg = jeng.config
  b, a = cfg.num_envs, cfg.num_actions
  _, act_key, learn_key = jax.random.split(js.rng, 3)
  act_taus = None
  if tspec.act_takes_taus:
    explore_u, random_action, act_taus = _act_draws(
        act_key, b, tspec.tau_samples_policy, a)
  else:
    _, policy_key = jax.random.split(act_key)
    explore_key, uniform_key = jax.random.split(policy_key)
    explore_u = _t(jax.random.uniform(explore_key, (b,)))
    random_action = _t(jax.random.randint(uniform_key, (b,), 0, a))
  sample_u, taus = [], []
  for k in jax.random.split(learn_key, cfg.updates_per_learn):
    sample_key, loss_key = jax.random.split(k)
    u_key = jax.random.split(sample_key, 3)[0]
    sample_u.append(_t(jax.random.uniform(u_key, (cfg.batch_size,))))
    if tspec.loss_takes_taus:
      taus.append(_loss_taus(loss_key, cfg.batch_size,
                             tspec.tau_samples_s_tm1))
  loss_taus = tuple(torch.stack(x) for x in zip(*taus)) if taus else None
  return SuperstepDraws(explore_u, random_action, torch.stack(sample_u), None,
                        act_taus, loss_taus)


def _host_engines(agent, game, num_envs, cap, **overrides):
  overrides.update(target_network_update_period=48)
  if agent == "iqn":  # 8 taus of each kind keep the test small
    overrides.update(tau_samples_policy=8, tau_samples_s_tm1=8,
                     tau_samples_s_t=8)
  jspec = dataclasses.replace(jget_agent(agent), **overrides)
  tspec = dataclasses.replace(get_agent(agent), **overrides)
  common = dict(game=game, num_envs=num_envs, slots_per_stream=16,
                batch_size=8, total_train_frames=20_000)
  farm = CppVectorEnv(game, num_envs, seed=4, num_threads=2,
                      episode_frame_cap=cap, device="cpu")
  # JAX's engine reads only these two of its env; the port's farm feeds
  # both engines.
  jeng = JHostEnvEngine(
      JEngineConfig(agent=jspec, env_config=JEnvConfig(
          episode_frame_cap=cap), **common),
      types.SimpleNamespace(batch_size=num_envs,
                            num_actions=farm.num_actions))
  teng = HostEnvEngine(EngineConfig(agent=tspec, env_config=VectorEnvConfig(
      episode_frame_cap=cap), **common), farm, device="cpu")
  return jeng, teng, farm


def _params_close(agent, tree, ref_tree, step):
  if agent == "iqn":  # Adam, as test_torch_iqn_learn holds it
    for a, w in zip(leaves(tree), leaves(ref_tree)):
      np.testing.assert_allclose(a.detach().numpy(), w.detach().numpy(),
                                 rtol=1e-4, atol=1e-6, err_msg=str(step))
    return
  # Centered RMSProp, as test_torch_slice holds the fused engine.
  diff = torch.cat([(a - w).detach().abs().flatten() for a, w in
                    zip(leaves(tree), leaves(ref_tree))])
  assert float(diff.max()) <= 5e-5, (step, float(diff.max()))
  assert float((diff <= 2e-6).float().mean()) >= 0.999, step


@pytest.mark.parametrize("agent,game,num_envs,cap", [
    ("dqn", "catch", 8, 1000), ("iqn", "pong", 4, 64)])
def test_host_engine_matches_jax_step_for_step(agent, game, num_envs, cap):
  jeng, teng, farm = _host_engines(agent, game, num_envs, cap)
  assert teng.config.num_actions == farm.num_actions
  jstate = jax.jit(jeng.init)(jax.random.PRNGKey(0))
  tstate = convert.host_engine_state_from_jax(teng, jax.device_get(jstate))
  group = farm.step(np.zeros((num_envs,), np.int32))
  swaps = 0
  for step in range(24):
    draws = jax_host_draws(jeng, teng.spec, jax.device_get(jstate))
    prev_target = [p.clone() for p in leaves(tstate.target_params)]
    jstate, jactions = jeng._device_step(
        jstate, group.obs84, group.reward_sum, group.discount_prod,
        group.is_first, group.is_last, group.reward_sum, group.frames_used)
    tstate, actions = teng.step(tstate, group, draws)
    np.testing.assert_array_equal(actions, np.asarray(jactions),
                                  err_msg=str(step))
    ref = convert.host_engine_state_from_jax(teng, jax.device_get(jstate))

    for f in ("frames", "stack_count", "action", "reward", "discount",
              "is_terminal", "row_t"):
      assert torch.equal(getattr(tstate.replay, f), getattr(ref.replay, f)), \
          (f, step)
    assert torch.equal(tstate.replay.indicator_tree[0],
                       ref.replay.indicator_tree[0])
    assert torch.equal(tstate.stack.frames, ref.stack.frames)
    assert tstate.env_frames == ref.env_frames
    assert tstate.telemetry.learn_steps == ref.telemetry.learn_steps
    if ref.telemetry.learn_steps:
      np.testing.assert_allclose(float(tstate.telemetry.last_loss),
                                 float(ref.telemetry.last_loss), rtol=1e-3)
    for tree, ref_tree in ((tstate.online_params, ref.online_params),
                           (tstate.target_params, ref.target_params)):
      _params_close(agent, tree, ref_tree, step)
    for f in ("episode_return", "episode_frames", "completed_return_sum",
              "completed_count"):
      assert torch.equal(getattr(tstate.telemetry, f),
                         getattr(ref.telemetry, f)), (f, step)
    assert bool(torch.isnan(tstate.telemetry.last_episode_return))
    swaps += any(not torch.equal(a, b) for a, b in
                 zip(prev_target, leaves(tstate.target_params)))
    group = farm.step(actions)

  assert ref.telemetry.learn_steps >= 8 and swaps >= 1
  got, want = teng.metrics(tstate), jeng.metrics(jstate)
  assert set(got) == set(want)
  for k in ("env_frames", "episodes", "learn_steps", "mean_episode_return"):
    assert got[k] == want[k], k
  np.testing.assert_allclose(got["last_loss"], want["last_loss"], rtol=1e-3)
  assert got["episodes"] > 0
  farm.close()


# --- an ALE-only cartridge ------------------------------------------------------------

# tests/test_ale_hook.py's mock libale: the ALE interface the farm's
# DZ_WITH_ALE backend calls, with a game that loses a life every 37 frames.
MOCK_ALE = """
#pragma once
#include <algorithm>
#include <string>
#include <vector>
namespace ale {
using Action = int;
using ActionVect = std::vector<int>;
class ALEInterface {
  int frame_ = 0, lives_ = 3;
  bool over_ = false;
 public:
  void setInt(const std::string&, int) {}
  void setFloat(const std::string&, float) {}
  void setBool(const std::string&, bool) {}
  void loadROM(const std::string&) {}
  ActionVect getMinimalActionSet() { return ActionVect{0, 1, 3, 4}; }
  int lives() { return lives_; }
  void reset_game() { frame_ = 0; lives_ = 3; over_ = false; }
  int act(Action a) {
    ++frame_;
    if (frame_ % 37 == 0 && !over_) { --lives_; if (lives_ <= 0) over_ = true; }
    return a == 1 ? 1 : 0;
  }
  bool game_over() { return over_; }
  void getScreenGrayscale(std::vector<unsigned char>& v) {
    v.assign(210 * 160, (unsigned char)std::min(frame_, 250));
  }
};
}  // namespace ale
using ale::ALEInterface;
"""


def test_ale_only_cartridge_trains_through_the_host_engine(tmp_path,
                                                           monkeypatch):
  cpp_before = set(os.listdir(cpp_bridge.CPP_DIR))
  inc = tmp_path / "include"
  inc.mkdir()
  (inc / "ale_interface.hpp").write_text(MOCK_ALE)
  lib = tmp_path / "libdz_env_ale_mock.so"
  proc = subprocess.run(
      [cpp_bridge.find_cxx(), "-O1", "-std=c++17", "-fPIC", "-Wall",
       "-pthread", "-DDZ_WITH_ALE", f"-I{inc}", "-shared", "-o", str(lib),
       str(cpp_bridge.CPP_DIR / "dz_env.cc")], capture_output=True, text=True)
  assert proc.returncode == 0, proc.stderr[-2000:]
  monkeypatch.setenv("DZ_ENV_LIB", str(lib))

  cfg = EngineConfig(
      agent=get_agent("dqn"), game="krull", num_envs=4, slots_per_stream=64,
      batch_size=8, total_train_frames=100_000,
      env_config=VectorEnvConfig(episode_frame_cap=1000))
  env = CppVectorEnv("krull", 4, seed=0, num_threads=1,
                     episode_frame_cap=1000, device="cpu")
  assert env.num_actions == 4
  eng = HostEnvEngine(cfg, env, device="cpu")
  assert eng._fused.game is None and eng._fused.env is None
  assert eng.config.num_actions == 4
  state = eng.init(0)
  state = eng.run(state, 50)
  m = eng.metrics(state)
  assert m["env_frames"] > 0, m
  assert m["episodes"] > 0, m  # the mock's game ends after 111 frames
  assert m["learn_steps"] > 0, m
  assert np.isfinite(m["last_loss"]), m
  assert bool(state.replay.frames.any())  # the mock's frames reached replay
  env.close()
  # Nothing of the port's was written into cpp/ (tests/test_ale_hook.py,
  # which may run at the same time, writes and removes its libdz_env_ale_*).
  new = set(os.listdir(cpp_bridge.CPP_DIR)) - cpp_before
  assert not [n for n in new if not n.startswith("libdz_env_ale_")], new
