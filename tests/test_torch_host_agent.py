"""Differential tests of the port's HostAgent (dqn_zoo_torch/host_agent.py)
against the JAX package's on the CPU, and port-only smoke runs.

JAX's HostAgent splits its key once per act and once per learn step
(host_agent.py:147, 156) and the spec's act and loss split further;
`jax_chain_draw` repeats those splits on a mirror of the JAX agent's key
and hands the port's agent, through its draw hook, the values JAX draws.
Both agents see the same raw timesteps of one JAX adapter; the port's
parameters and optimizer state start from JAX's through convert.
"""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dqn_zoo_tpu import processors as jprocessors
from dqn_zoo_tpu.agents import get_agent as jget_agent
from dqn_zoo_tpu.envs.dm_adapter import JaxGameEnvironment
from dqn_zoo_tpu.host_agent import HostAgent as JHostAgent
from dqn_zoo_torch import convert, parts, processors
from dqn_zoo_torch.agents import get_agent
from dqn_zoo_torch.agents.base import all_agent_names
from dqn_zoo_torch.engine.superstep import leaves
from dqn_zoo_torch.envs.dm_adapter import GameEnvironment
from dqn_zoo_torch.host_agent import HostAgent
from test_torch_rainbow import _jax_loss_noise, jax_noise
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SAMPLE = np.zeros((84, 84, 4), np.uint8)
split = jax.random.split
_t = lambda x: torch.from_numpy(np.array(x))


def jax_chain_draw(jagent, spec, num_actions):
  """A draw hook for the port's agent that gives the values JAX's agent
  draws, from a mirror of its key (`mirror["key"]`, which must equal the
  JAX agent's key after each frame). dqn's act: split(act_key) → apply,
  policy; policy → explore, uniform (ops/policy.py:20-28); rainbow's act
  draws the noise from the apply key, its loss three noise sets from
  split(loss_key, 4)[1:]."""
  mirror = {"key": jagent._rng_key}
  atoms = spec.num_atoms

  def draw(kind):
    mirror["key"], sub = split(mirror["key"])
    if kind == "learn":
      return (_jax_loss_noise(sub, num_actions, atoms)
              if spec.loss_takes_noise else ())
    apply_key, policy_key = split(sub)
    explore_key, uniform_key = split(policy_key)
    out = (_t(jax.random.uniform(explore_key, (1,))),
           _t(jax.random.randint(uniform_key, (1,), 0, num_actions)))
    if spec.act_takes_noise:
      out += (jax_noise(apply_key, num_actions, atoms),)
    return out

  return draw, mirror


def _stored(replay):
  return [tr for _, tr in replay.get_state()["storage"]["items"]]


def _params_close(tree, ref_tree, what):
  """As tests/test_torch_slice.py and test_torch_rainbow.py hold them:
  within 5e-5, 99.9 % of the leaves' values within 2e-6."""
  diff = torch.cat([(a - w).detach().abs().flatten() for a, w in
                    zip(leaves(tree), leaves(ref_tree))])
  assert float(diff.max()) <= 5e-5, (what, float(diff.max()))
  assert float((diff <= 2e-6).float().mean()) >= 0.999, what


@pytest.mark.parametrize("name", ["dqn", "rainbow"])
def test_host_agent_matches_jax_step_for_step(name):
  """dqn (uniform replay, centred RMSProp, ε from 1 to 0.1 over frames
  20-60 of learning) and rainbow (prioritized, n-step 3, noisy C51, Adam +
  clip) on catch, 200 frames, ~8 learn steps: the action at every frame
  and the replay's contents exact, the loss within rtol 1e-3, the
  parameters as the engine tests hold them."""
  overrides = dict(min_replay_capacity_fraction=0.04,
                   target_network_update_period=64)
  kw = dict(num_actions=3, sample_network_input=SAMPLE, replay_capacity=500,
            total_frames=2_000)
  jspec = dataclasses.replace(jget_agent(name), **overrides)
  tspec = dataclasses.replace(get_agent(name), **overrides)
  jagent = JHostAgent(jspec, rng_key=jax.random.PRNGKey(0),
                      preprocessor=jprocessors.atari(), **kw)
  tagent = HostAgent(tspec, seed=0, preprocessor=processors.atari(),
                     device="cpu", **kw)
  tagent.set_state(convert.host_agent_state_from_jax(
      tagent, jax.device_get(jagent.get_state()), "cpu"))
  _params_close(tagent.online_params, convert.params_from_jax(
      jax.device_get(jagent.online_params), "cpu"), "initial")
  tagent.draw, mirror = jax_chain_draw(jagent, tspec, 3)

  env = JaxGameEnvironment("catch", seed=3, max_noops=3)
  learned, greedy = 0, 0
  timestep = None
  for frame in range(200):
    if timestep is None or timestep.last():
      jagent.reset()
      tagent.reset()
      timestep = env.reset()
    loss_before = jagent._statistics.get("loss")
    a = tagent.step(timestep)
    w = jagent.step(timestep)
    assert a == w, frame
    assert jnp.array_equal(mirror["key"], jagent._rng_key), frame
    if jagent._statistics.get("loss") is not loss_before:
      learned += 1
      np.testing.assert_allclose(tagent._statistics["loss"],
                                 jagent._statistics["loss"], rtol=1e-3)
    greedy += float(jagent._exploration_epsilon(frame)) < 0.5
    timestep = env.step(w)
  assert learned >= 6 and greedy >= 80
  assert tagent._frame_t == jagent._frame_t
  got, want = _stored(tagent._replay), _stored(jagent._replay)
  assert len(got) == len(want) > 40
  for g, v in zip(got, want):
    for f in g._fields:
      assert np.array_equal(np.asarray(getattr(g, f)),
                            np.asarray(getattr(v, f))), f
  _params_close(tagent.online_params, convert.params_from_jax(
      jax.device_get(jagent.online_params), "cpu"), "online")
  _params_close(tagent.target_params, convert.params_from_jax(
      jax.device_get(jagent.target_params), "cpu"), "target")
  if tspec.priority_exponent > 0:
    assert tagent._max_seen_priority == pytest.approx(
        jagent._max_seen_priority, rel=1e-3)
    assert tagent._replay.check_valid()[0]


@pytest.mark.parametrize("name", all_agent_names())
def test_host_agent_smoke_all_specs(name):
  """Every spec through run_loop on the port's catch adapter, 300 frames
  at batch 8 (iqn's τ sets of 8): ~12 learn steps with a finite loss; a
  prioritized replay stays valid."""
  overrides = dict(min_replay_capacity_fraction=0.05, batch_size=8,
                   target_network_update_period=100)
  if name == "iqn":
    overrides.update(tau_samples_policy=8, tau_samples_s_tm1=8,
                     tau_samples_s_t=8)
  spec = dataclasses.replace(get_agent(name), **overrides)
  agent = HostAgent(spec, 3, SAMPLE, seed=1, preprocessor=processors.atari(),
                    replay_capacity=500, total_frames=10_000, device="cpu")
  env = GameEnvironment("catch", seed=3, max_noops=3, device="cpu")
  loop = parts.run_loop(agent, env, max_steps_per_episode=200)
  stats = parts.generate_statistics(parts.make_default_trackers(agent),
                                    itertools.islice(loop, 300))
  assert stats["num_steps_since_reset"] == 300
  assert np.isfinite(stats["state_value"])
  assert np.isfinite(agent._statistics.get("loss", np.nan))
  if agent._prioritized:
    ok, msg = agent._replay.check_valid()
    assert ok, msg


def test_host_agent_state_roundtrip_determinism():
  """get_state/set_state transplants the whole agent: the clone picks the
  same actions on the same timesteps (the JAX package's
  test_host_agent_state_roundtrip_determinism, on the port's pong)."""

  def make():
    spec = dataclasses.replace(get_agent("prioritized"),
                               min_replay_capacity_fraction=0.1,
                               learn_period=8)
    return HostAgent(spec, 6, SAMPLE, seed=0,
                     preprocessor=processors.atari(), replay_capacity=500,
                     total_frames=10_000, device="cpu")

  agent = make()
  loop = parts.run_loop(agent, GameEnvironment("pong", seed=5, max_noops=2,
                                               device="cpu"),
                        max_steps_per_episode=200)
  for _ in itertools.islice(loop, 300):
    pass
  assert "loss" in agent._statistics
  state = agent.get_state()
  clone = make()
  clone.set_state(state)
  env_a = GameEnvironment("pong", seed=9, max_noops=2, device="cpu")
  env_b = GameEnvironment("pong", seed=9, max_noops=2, device="cpu")
  agent.reset()
  clone.reset()
  ts_a, ts_b = env_a.reset(), env_b.reset()
  for _ in range(40):
    a, b = agent.step(ts_a), clone.step(ts_b)
    assert a == b
    ts_a, ts_b = env_a.step(a), env_b.step(b)
  assert agent._statistics["loss"] == clone._statistics["loss"]
