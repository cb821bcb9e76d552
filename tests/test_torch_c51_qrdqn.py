"""Differential tests of the c51 and qrdqn slice against the JAX package (CPU):
the C51 and QR-DQN networks, the categorical Q-learning op, each agent's
loss, gradients and clipped Adam step, both specs, c51/seaquest and
qrdqn/seaquest supersteps of both engines, and the runners. Each test is
parametrised over the two agents where both go through it."""

import csv
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_rainbow import _batch, _categorical_inputs, _tree_keys
from test_torch_seaquest import jax_seaquest_env_draws
from torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_slice import _assert_u8_close

from dqn_zoo_tpu import ops as jops
from dqn_zoo_tpu.agents import get_agent as jget_agent
from dqn_zoo_tpu.agents.base import make_optimizer as jmake_optimizer
from dqn_zoo_tpu.agents.qrdqn import quantiles as jquantiles
from dqn_zoo_tpu.engine import Engine as JEngine
from dqn_zoo_tpu.engine import EngineConfig as JEngineConfig
from dqn_zoo_tpu.envs.vector import VectorEnvConfig as JEnvConfig
from dqn_zoo_torch import convert, ops
from dqn_zoo_torch.agents import AdamState, get_agent, make_optimizer
from dqn_zoo_torch.agents.base import ClipByGlobalNorm
from dqn_zoo_torch.agents.qrdqn import quantiles
from dqn_zoo_torch.engine import Engine, EngineConfig, SuperstepDraws
from dqn_zoo_torch.engine.superstep import leaves
from dqn_zoo_torch.envs.vector import VectorEnvConfig
from dqn_zoo_torch.replay.device_replay import TransitionBatch
from dqn_zoo_torch.run.agents import run_agent

AGENTS = ["c51", "qrdqn"]
NUM_ACTIONS = 18  # seaquest
_t = lambda x: torch.from_numpy(np.array(x))


@functools.lru_cache(maxsize=None)
def _jax_params(name, seed):
  """name/seaquest parameters of the JAX package from PRNGKey(seed)."""
  spec = jget_agent(name)
  net = spec.make_network(spec, NUM_ACTIONS)
  return jax.device_get(jax.jit(net.init)(
      jax.random.PRNGKey(seed), jnp.zeros((1, 84, 84, 4), jnp.uint8)))


def _dist(out):
  """The net's distribution output: C51's logits or QR-DQN's quantiles."""
  return out.q_logits if hasattr(out, "q_logits") else out.q_dist


# --- the networks -------------------------------------------------------------


@pytest.mark.parametrize("name,shape", [("c51", (4, NUM_ACTIONS, 51)),
                                        ("qrdqn", (4, 201, NUM_ACTIONS))],
                         ids=AGENTS)
def test_forward_matches_jax(name, shape):
  """The distribution and q_values at B=4 from JAX's weights: rtol 1e-5,
  atol 1e-5 (f32 convolutions and products summed in another order), each
  head in its own layout (C51 actions first, QR-DQN quantiles first). The
  port's own init has JAX's layout."""
  jspec, tspec = jget_agent(name), get_agent(name)
  jnet = jspec.make_network(jspec, NUM_ACTIONS)
  x = np.random.RandomState(5).randint(0, 256, (4, 84, 84, 4)).astype(
      np.uint8)
  params = _jax_params(name, 0)
  want = jax.jit(jnet.apply)(params, jax.random.PRNGKey(3), x)

  tnet = tspec.make_network(tspec, NUM_ACTIONS)
  mine = tnet.init(torch.Generator().manual_seed(0), "cpu")
  assert _tree_keys(mine) == _tree_keys(params)
  assert len(leaves(mine)) == len(jax.tree.leaves(params)) == 10
  got = tnet.apply(convert.params_from_jax(params, "cpu"), _t(x))
  assert tuple(_dist(got).shape) == shape
  np.testing.assert_allclose(_dist(got).numpy(), np.asarray(_dist(want)),
                             rtol=1e-5, atol=1e-5)
  np.testing.assert_allclose(got.q_values.numpy(), np.asarray(want.q_values),
                             rtol=1e-5, atol=1e-5)
  assert not got.q_values.requires_grad


def test_quantiles_match_jax():
  for n in (201, 51, 7):
    spec = dataclasses.replace(get_agent("qrdqn"), num_quantiles=n)
    np.testing.assert_array_equal(quantiles(spec).numpy(),
                                  np.asarray(jquantiles(spec)))


# --- the categorical op -------------------------------------------------------


def test_categorical_q_learning_matches_jax():
  """The greedy a_t from the target distribution's own mean; targets beyond
  ±vmax and terminal rows. Per-row losses rtol 1e-6 (~4, 51 terms summed in
  another order), their gradient to the online logits 1e-6 abs."""
  c = _categorical_inputs(np.random.RandomState(12), a=NUM_ACTIONS)

  def jloss(logits):
    return jops.batch_categorical_q_learning(
        c["z"], logits, c["a"], c["r"], c["d"], c["z"], c["logits_t"])

  want = jloss(c["logits_tm1"])
  want_grad = jax.grad(lambda x: jnp.sum(jloss(x)))(c["logits_tm1"])
  logits = _t(c["logits_tm1"]).requires_grad_(True)
  got = ops.batch_categorical_q_learning(
      _t(c["z"]), logits, _t(c["a"]), _t(c["r"]), _t(c["d"]), _t(c["z"]),
      _t(c["logits_t"]))
  grad, = torch.autograd.grad(got.sum(), logits)
  np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                             rtol=1e-6, atol=0)
  np.testing.assert_allclose(grad.numpy(), np.asarray(want_grad), rtol=0,
                             atol=1e-6)


# --- the specs, losses, gradients and the clipped Adam step -------------------


@pytest.mark.parametrize("name", AGENTS)
def test_spec_has_the_jax_values(name):
  jspec, tspec = jget_agent(name), get_agent(name)
  for f in dataclasses.fields(tspec):
    if f.name not in ("make_network", "loss", "act", "act_takes_taus",
                      "loss_takes_taus", "act_takes_noise",
                      "loss_takes_noise"):
      assert getattr(tspec, f.name) == getattr(jspec, f.name), f.name
  assert not (tspec.act_takes_taus or tspec.loss_takes_taus
              or tspec.act_takes_noise or tspec.loss_takes_noise)
  assert isinstance(make_optimizer(tspec), ClipByGlobalNorm)


@functools.partial(jax.jit, static_argnums=0)
def _jax_loss_and_grads(name, online, target, batch, weights, key):
  spec = jget_agent(name)
  net = spec.make_network(spec, NUM_ACTIONS)

  def loss_fn(p):
    out = spec.loss(spec, net, p, target, batch, weights, key)
    return out.loss, out.priorities

  return jax.value_and_grad(loss_fn, has_aux=True)(online)


@functools.partial(jax.jit, static_argnums=0)
def _jax_clipped_adam_step(name, grads, params):
  """optax.chain(clip_by_global_norm(10), adam) from its initial state."""
  opt = jmake_optimizer(jget_agent(name))
  updates, state = opt.update(grads, opt.init(params))
  return optax.apply_updates(params, updates), state


@pytest.mark.parametrize("name,weight_scale,above", [
    ("c51", 1.0, False), ("c51", 400.0, True),
    ("qrdqn", 1.0, False), ("qrdqn", 400.0, True)],
    ids=["c51-norm_below_10", "c51-norm_above_10", "qrdqn-norm_below_10",
         "qrdqn-norm_above_10"])
def test_loss_gradients_and_clipped_step_match_jax(name, weight_scale, above):
  """Loss rtol 1e-5 and priorities rtol 1e-5, atol 1e-6; every gradient
  leaf within a relative Frobenius error of 1e-5 and elementwise rtol 1e-3
  with atol 1e-5 of the leaf's largest magnitude (f32 convolutions and
  products summed in another order); then one step of the port's clip +
  Adam from JAX's gradients against optax.chain(clip_by_global_norm(10),
  adam) at rtol 1e-6, atol 1e-9, with the converter finding Adam's state
  inside the chain's: moments rtol 1e-6, 2e-6 where the clip acts (see
  below). As rainbow's test holds its agent."""
  tspec = get_agent(name)
  online, target = _jax_params(name, 0), _jax_params(name, 1)
  rng = np.random.RandomState(10)
  b = 6
  batch = _batch(rng, b, NUM_ACTIONS)
  weights = (rng.uniform(0.2, 1.0, b) * weight_scale).astype(np.float32)

  (jloss, jprio), jgrads = _jax_loss_and_grads(
      name, online, target, batch, weights, jax.random.PRNGKey(11))
  norm = float(optax.global_norm(jgrads))
  assert (norm > 10.0) == above and abs(norm - 10.0) > 1.0, norm

  tnet = tspec.make_network(tspec, NUM_ACTIONS)
  tonline = convert.params_from_jax(online, "cpu", requires_grad=True)
  out = tspec.loss(tspec, tnet, tonline, convert.params_from_jax(
      target, "cpu"), TransitionBatch(*(_t(v) for v in batch)), _t(weights))
  np.testing.assert_allclose(float(out.loss.detach()), float(jloss),
                             rtol=1e-5)
  assert not out.priorities.requires_grad
  np.testing.assert_allclose(out.priorities.numpy(), np.asarray(jprio),
                             rtol=1e-5, atol=1e-6)
  grads = torch.autograd.grad(out.loss, leaves(tonline))
  jleaves = jax.tree.leaves(jgrads)
  assert len(grads) == len(jleaves) == 10
  for g, w in zip(grads, jleaves):
    w = np.asarray(w)
    assert np.linalg.norm(g.numpy() - w) <= 1e-5 * np.linalg.norm(w)
    np.testing.assert_allclose(g.numpy(), w, rtol=1e-3,
                               atol=1e-5 * float(np.abs(w).max()))

  jnew, jstate = _jax_clipped_adam_step(name, jgrads, online)
  topt = make_optimizer(tspec)
  tparams = convert.params_from_jax(online, "cpu")
  tstate = topt.init(leaves(tparams))
  topt.step(leaves(tparams), leaves(convert.params_from_jax(
      jax.device_get(jgrads), "cpu")), tstate)
  for a, p in zip(leaves(tparams), jax.tree.leaves(jnew)):
    np.testing.assert_allclose(a.numpy(), np.asarray(p), rtol=1e-6,
                               atol=1e-9)
  conv = convert.opt_state_from_jax(jax.device_get(jstate), "cpu")
  assert isinstance(conv, AdamState) and int(conv.count) == 1
  # Above 10 the clip scales by the global norm, a sum of 1.7-3.5 M squares
  # in another order on each side (qrdqn: JAX's 2.5e-7 below the f64 sum,
  # the port's 1e-7 above it); the second moment takes its square.
  moment_rtol = 2e-6 if above else 1e-6
  for a, w in zip(tstate.mu + tstate.nu, conv.mu + conv.nu):
    np.testing.assert_allclose(a.numpy(), w.numpy(), rtol=moment_rtol,
                               atol=1e-12)


# --- c51/seaquest and qrdqn/seaquest supersteps -------------------------------


def _engines(name):
  overrides = dict(target_network_update_period=96)
  jspec = dataclasses.replace(jget_agent(name), **overrides)
  tspec = dataclasses.replace(get_agent(name), **overrides)
  common = dict(game="seaquest", num_envs=4, slots_per_stream=16,
                batch_size=8, learn_every=1, updates_per_learn=1,
                total_train_frames=20_000)
  return (JEngine(JEngineConfig(agent=jspec, env_config=JEnvConfig(
      episode_frame_cap=36), **common)),
          Engine(EngineConfig(agent=tspec, env_config=VectorEnvConfig(
              episode_frame_cap=36), **common), device="cpu"))


def _jax_draws(jeng, jstate) -> SuperstepDraws:
  """The draws JAX's Engine.superstep makes from jstate.rng (uniform
  replay, one update a superstep)."""
  cfg = jeng.config
  _, act_key, learn_key = jax.random.split(jstate.rng, 3)
  _, policy_key = jax.random.split(act_key)
  explore_key, uniform_key = jax.random.split(policy_key)
  b = cfg.num_envs
  u_key = jax.random.split(jax.random.split(learn_key)[0], 3)[0]
  return SuperstepDraws(
      _t(jax.random.uniform(explore_key, (b,))),
      _t(jax.random.randint(uniform_key, (b,), 0, NUM_ACTIONS)),
      _t(jax.random.uniform(u_key, (1, cfg.batch_size))),
      jax_seaquest_env_draws(jstate.env))


@pytest.mark.parametrize("name", AGENTS)
def test_seaquest_supersteps_match_jax(name):
  """Bounds as the dqn/pong slice test's: rows, the tree, the game state and
  the frame count exact; frames within K2's ±1; loss rtol 1e-3; 99.9 % of
  the parameters within 2e-6, all within max(5e-5, lr/2). An Adam step
  moves a weight by up to ~lr and is steepest for gradients near eps
  (3.1e-4), where the ±1 observation pixels move it by a fraction of lr:
  c51's lr of 2.5e-4 took a conv2 bias 5.3e-5 away in 10 steps (qrdqn at
  5e-5: 8.8e-6)."""
  jeng, teng = _engines(name)
  bound = max(5e-5, teng.spec.learning_rate / 2)
  jstate = jax.device_put(jax.device_get(jax.jit(jeng.init)(
      jax.random.PRNGKey(4))))
  tstate = convert.engine_state_from_jax(teng, jax.device_get(jstate))
  jstep = jax.jit(jeng.superstep)
  learned = swaps = 0
  for step in range(12):
    draws = _jax_draws(jeng, jax.device_get(jstate))
    prev_target = [p.clone() for p in leaves(tstate.target_params)]
    jstate = jstep(jstate)
    tstate = teng.superstep(tstate, draws)
    ref = convert.engine_state_from_jax(teng, jax.device_get(jstate))

    for f in ("stack_count", "action", "reward", "discount", "is_terminal",
              "row_t"):
      assert torch.equal(getattr(tstate.replay, f), getattr(ref.replay, f)), \
          (f, step)
    _assert_u8_close(tstate.replay.frames, ref.replay.frames, step)
    assert torch.equal(tstate.replay.indicator_tree[0],
                       ref.replay.indicator_tree[0])
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
      diff = torch.cat([(a - w).detach().abs().flatten() for a, w in
                        zip(leaves(tree), leaves(ref_tree))])
      assert float(diff.max()) <= bound, (step, float(diff.max()))
      assert float((diff <= 2e-6).float().mean()) >= 0.999, step
    learned = ref.telemetry.learn_steps
    swaps += any(not torch.equal(a, b) for a, b in
                 zip(prev_target, leaves(tstate.target_params)))
  assert learned >= 5 and swaps >= 1
  assert bool(ref.replay.is_terminal.any())  # truncations were inserted
  assert isinstance(tstate.opt_state, AdamState)
  assert int(tstate.opt_state.count) == learned


# --- the runners --------------------------------------------------------------


@pytest.mark.parametrize("name", AGENTS)
def test_runner_trains_on_cpu(name, tmp_path):
  path = tmp_path / "r.csv"
  run_agent(name, ["--device=cpu", "--environment_name=seaquest",
                   "--num_envs=2", "--replay_capacity=64",
                   "--min_replay_capacity_fraction=0.1", "--batch_size=8",
                   "--num_iterations=1", "--num_train_frames=64",
                   "--num_eval_frames=32", "--max_frames_per_episode=16",
                   f"--results_csv_path={path}"])
  rows = list(csv.DictReader(open(path)))
  assert [int(r["iteration"]) for r in rows] == [0, 1]
  assert float(rows[1]["train_num_episodes"]) > 0
  assert rows[1]["train_state_value"] != "nan"
  assert 0.0 < float(rows[1]["train_exploration_epsilon"]) < 1.0
