"""Differential tests of the rainbow slice against the JAX package (CPU): the
noisy layer and its noise, the noisy dueling C51 network, the categorical
projection and double-Q loss, rainbow's loss, gradients and clipped Adam
step, rainbow/catch supersteps of both engines, and the runner.

JAX draws each noisy apply's noise from a key; the port takes it as an
argument. `jax_noise` repeats JAX's key splits (nets/atari.py:231-234 and
nets/core.py:213-218 of the JAX package, with core.sequential's `fold_in`
per layer index) and hands the port the values JAX drew."""

import csv
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from scipy import stats

from test_torch_catch import jax_catch_env_draws
from test_torch_replay import _jax_sample_uniforms
from test_torch_slice import _assert_u8_close

from dqn_zoo_tpu import ops as jops
from dqn_zoo_tpu.agents import get_agent as jget_agent
from dqn_zoo_tpu.agents.base import make_optimizer as jmake_optimizer
from dqn_zoo_tpu.agents.c51 import support as jsupport
from dqn_zoo_tpu.engine import Engine as JEngine
from dqn_zoo_tpu.engine import EngineConfig as JEngineConfig
from dqn_zoo_tpu.nets import core as jcore
from dqn_zoo_tpu.replay.device_replay import TransitionBatch as JBatch
from dqn_zoo_torch import convert, nets, ops
from dqn_zoo_torch.agents import AdamState, get_agent, make_optimizer
from dqn_zoo_torch.agents.base import ClipByGlobalNorm
from dqn_zoo_torch.agents.c51 import support
from dqn_zoo_torch.engine import Engine, EngineConfig, SuperstepDraws
from dqn_zoo_torch.engine.superstep import leaves
from dqn_zoo_torch.nets import core
from dqn_zoo_torch.replay.device_replay import TransitionBatch
from dqn_zoo_torch.run.agents import run_agent
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

_t = lambda x: torch.from_numpy(np.array(x))


def _noise_sqrt(key, size):
  e = jax.random.truncated_normal(key, -2.0, 2.0, (1, size))
  return (jnp.sign(e) * jnp.sqrt(jnp.abs(e)))[0]


def _jax_noise_pair(key, fan_in, n):
  """JAX noisy_linear's (ε_in, ε_out) for one apply key."""
  in_key, out_key = jax.random.split(key)
  return _noise_sqrt(in_key, fan_in), _noise_sqrt(out_key, n)


@functools.partial(jax.jit, static_argnums=(1, 2))
def _jax_noise_arrays(key, num_actions, num_atoms):
  _, adv_key, val_key = jax.random.split(key, 3)
  out = []
  for stream_key, n_out in ((adv_key, num_actions * num_atoms),
                            (val_key, num_atoms)):
    # hidden is layer 0 of the sequential, out is layer 2 (after the ReLU).
    out += _jax_noise_pair(jax.random.fold_in(stream_key, 0), 3136, 512)
    out += _jax_noise_pair(jax.random.fold_in(stream_key, 2), 512, n_out)
  return out


def jax_noise(key, num_actions, num_atoms) -> nets.RainbowNoise:
  """The noise rainbow_atari_network's apply draws from `key`."""
  return nets.RainbowNoise(*(_t(x) for x in _jax_noise_arrays(
      key, num_actions, num_atoms)))


def _jax_loss_noise(loss_key, num_actions, num_atoms):
  """rainbow_loss's three noise sets: split(key, 4)[1:]."""
  _, k0, k1, k2 = jax.random.split(loss_key, 4)
  return tuple(jax_noise(k, num_actions, num_atoms) for k in (k0, k1, k2))


@functools.lru_cache(maxsize=None)
def _jax_params(seed):
  """rainbow/pong parameters of the JAX package from PRNGKey(seed)."""
  spec = jget_agent("rainbow")
  net = spec.make_network(spec, 6)
  return jax.device_get(jax.jit(net.init)(
      jax.random.PRNGKey(seed), jnp.zeros((1, 84, 84, 4), jnp.uint8)))


def _batch(rng, b, num_actions=6):
  return JBatch(
      s_tm1=rng.randint(0, 256, (b, 84, 84, 4)).astype(np.uint8),
      a_tm1=rng.randint(0, num_actions, b).astype(np.int32),
      r_t=rng.choice([-1.0, 0.0, 1.0], b).astype(np.float32),
      discount_t=(0.99 * rng.randint(0, 2, b)).astype(np.float32),
      s_t=rng.randint(0, 256, (b, 84, 84, 4)).astype(np.uint8))


def _tree_keys(tree):
  """The nested keys of a params tree, without JAX's empty ReLU entries."""
  if not isinstance(tree, dict):
    return tuple(tree.shape)
  return {k: _tree_keys(v) for k, v in tree.items()
          if not (isinstance(v, dict) and not v)}


# --- the noisy layer and its noise ------------------------------------------------


@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "no_bias"])
def test_noisy_linear_matches_jax(with_bias):
  """Init layout and σ exact; the apply within 1e-6 abs (f32 products
  summed in another order)."""
  fan_in, n, b = 96, 40, 5
  layer = jcore.noisy_linear(n, 0.3, with_bias=with_bias)
  x = np.random.RandomState(0).randn(b, fan_in).astype(np.float32)
  params, _ = layer.init(jax.random.PRNGKey(1),
                         jax.ShapeDtypeStruct((b, fan_in), jnp.float32))
  rng = jax.random.PRNGKey(2)
  want = np.asarray(layer.apply(params, rng, x))

  mine = core.noisy_linear_init(torch.Generator().manual_seed(0), fan_in, n,
                                0.3, with_bias, "cpu")
  assert _tree_keys(mine) == _tree_keys(jax.device_get(params))
  for k in ("w", "b"):
    np.testing.assert_array_equal(mine["sigma"][k].numpy(),
                                  np.asarray(params["sigma"][k]))
  p = convert.params_from_jax(jax.device_get(params), "cpu")
  got = core.noisy_linear(_t(x), p, *(_t(v) for v in _jax_noise_pair(
      rng, fan_in, n)))
  np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_noise_transform_is_exact_and_the_draw_is_a_truncated_normal():
  """sign(e)·√|e| bit for bit against jnp (and the correctly rounded
  root); the torch draw's noise, squared
  back with its sign, over 1e5 samples has the truncated normal's mean 0,
  variance 0.7737 and mean |e| within 5 standard errors, and |e| <= 2."""
  e = np.concatenate([np.random.RandomState(3).uniform(-2, 2, 4093),
                      [0.0, -2.0, 2.0]]).astype(np.float32)
  np.testing.assert_array_equal(
      core.noise_sqrt(_t(e)).numpy(),
      np.asarray(jnp.sign(e) * jnp.sqrt(jnp.abs(e))))

  n = 100_000
  gen = torch.Generator().manual_seed(4)
  noise = core.noise_draw(gen, (n,), "cpu").double()
  back = (torch.sign(noise) * noise * noise).numpy()
  tn = stats.truncnorm(-2.0, 2.0)
  var = tn.var()
  assert abs(var - 0.7737) < 1e-4
  m4 = tn.moment(4)
  abs_mean = 2 * (stats.norm.pdf(0) - stats.norm.pdf(2)) / (
      stats.norm.cdf(2) - stats.norm.cdf(-2))
  assert np.abs(back).max() <= 2.0
  assert abs(back.mean()) < 5 * np.sqrt(var / n)
  assert abs(np.mean(back ** 2) - var) < 5 * np.sqrt((m4 - var ** 2) / n)
  assert abs(np.abs(back).mean() - abs_mean) < \
      5 * np.sqrt((var - abs_mean ** 2) / n)
  # One engine draw holds the eight vectors of RainbowNoise.
  net = nets.rainbow_atari_network(6, support(get_agent("rainbow")), 0.1)
  sets = net.draw_noise(gen, "cpu", (2, 3))
  assert [tuple(x.shape) for x in sets] == [(2, 3, s)
                                            for s in net.noise_sizes()]


# --- the network -------------------------------------------------------------------


def test_support_matches_jax():
  """Each atom the f32 nearest to its exact value; jnp.linspace's compiled
  f32 product lands within 1.25 ulp of vmax of it: 2 ulp of vmax."""
  for vmax, atoms in ((10.0, 51), (7.3, 33), (1.0, 2), (3.7, 201)):
    spec = dataclasses.replace(get_agent("rainbow"), vmax=vmax,
                               num_atoms=atoms)
    np.testing.assert_allclose(
        support(spec).numpy(), np.asarray(jsupport(spec)), rtol=0,
        atol=2 * np.spacing(np.float32(vmax)))


def test_rainbow_forward_matches_jax():
  """q_logits and q_values at B=4, pong's 6 actions, 51 atoms, from JAX's
  weights and noise: rtol 1e-5, atol 1e-5 (f32 convolutions and products
  summed in another order). The port's own init has JAX's layout."""
  jspec, tspec = jget_agent("rainbow"), get_agent("rainbow")
  jnet = jspec.make_network(jspec, 6)
  x = np.random.RandomState(5).randint(0, 256, (4, 84, 84, 4)).astype(
      np.uint8)
  params = _jax_params(0)
  rng = jax.random.PRNGKey(3)
  want = jax.jit(jnet.apply)(params, rng, x)

  tnet = tspec.make_network(tspec, 6)
  mine = tnet.init(torch.Generator().manual_seed(0), "cpu")
  assert _tree_keys(mine) == _tree_keys(params)
  assert len(leaves(mine)) == len(jax.tree.leaves(params)) == 20
  got = tnet.apply(convert.params_from_jax(params, "cpu"), _t(x),
                   jax_noise(rng, 6, 51))
  assert tuple(got.q_logits.shape) == (4, 6, 51)
  np.testing.assert_allclose(got.q_logits.numpy(), np.asarray(want.q_logits),
                             rtol=1e-5, atol=1e-5)
  np.testing.assert_allclose(got.q_values.numpy(), np.asarray(want.q_values),
                             rtol=1e-5, atol=1e-5)


# --- the categorical ops -----------------------------------------------------------


def _categorical_inputs(rng, b=16, a=6, atoms=51):
  z = np.asarray(jsupport(get_agent("rainbow")))
  # Rewards up to ±15 take atoms beyond ±vmax; a quarter of the rows are
  # terminal (discount 0): their whole target lands at r.
  r = rng.uniform(-15, 15, b).astype(np.float32)
  d = (rng.uniform(0, 1, b) * (rng.uniform(0, 1, b) > 0.25)).astype(
      np.float32)
  d[:2] = 0.0
  return dict(
      z=z, r=r, d=d, a=rng.randint(0, a, b).astype(np.int32),
      logits_tm1=rng.randn(b, a, atoms).astype(np.float32),
      logits_t=rng.randn(b, a, atoms).astype(np.float32),
      selector=rng.randn(b, a).astype(np.float32))


def test_categorical_l2_project_matches_jax():
  """Targets beyond ±vmax and terminal rows: 1e-6 abs."""
  rng = np.random.RandomState(8)
  c = _categorical_inputs(rng)
  z_p = c["r"][:, None] + c["d"][:, None] * c["z"][None, :]
  probs = jax.nn.softmax(rng.randn(16, 51).astype(np.float32))
  want = jax.vmap(jops.categorical_l2_project, in_axes=(0, 0, None))(
      z_p, probs, c["z"])
  got = ops.categorical_l2_project(_t(z_p), _t(probs), _t(c["z"]))
  assert float(np.abs(z_p).max()) > 10.0
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                             atol=1e-6)
  np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-5)


def test_categorical_double_q_learning_matches_jax():
  """The per-row losses (~4, 51 terms summed in another order) rtol 1e-6,
  a few ulp; their gradient to the online logits 1e-6 abs."""
  c = _categorical_inputs(np.random.RandomState(9))

  def jloss(logits):
    return jops.batch_categorical_double_q_learning(
        c["z"], logits, c["a"], c["r"], c["d"], c["z"], c["logits_t"],
        c["selector"])

  want = jloss(c["logits_tm1"])
  want_grad = jax.grad(lambda x: jnp.sum(jloss(x)))(c["logits_tm1"])
  logits = _t(c["logits_tm1"]).requires_grad_(True)
  got = ops.batch_categorical_double_q_learning(
      _t(c["z"]), logits, _t(c["a"]), _t(c["r"]), _t(c["d"]), _t(c["z"]),
      _t(c["logits_t"]), _t(c["selector"]))
  grad, = torch.autograd.grad(got.sum(), logits)
  np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                             rtol=1e-6, atol=0)
  np.testing.assert_allclose(grad.numpy(), np.asarray(want_grad), rtol=0,
                             atol=1e-6)


# --- the loss, its gradients and the clipped Adam step ------------------------------


def test_spec_has_the_jax_values():
  jspec, tspec = jget_agent("rainbow"), get_agent("rainbow")
  for f in dataclasses.fields(tspec):
    if f.name not in ("make_network", "loss", "act", "act_takes_taus",
                      "loss_takes_taus", "act_takes_noise",
                      "loss_takes_noise"):
      assert getattr(tspec, f.name) == getattr(jspec, f.name), f.name
  assert tspec.act_takes_noise and tspec.loss_takes_noise
  assert (tspec.n_step, tspec.max_global_grad_norm, tspec.optimizer) == \
      (3, 10.0, "adam")
  assert isinstance(make_optimizer(tspec), ClipByGlobalNorm)


@jax.jit
def _jax_loss_and_grads(online, target, batch, weights, key):
  spec = jget_agent("rainbow")
  net = spec.make_network(spec, 6)

  def loss_fn(p):
    out = spec.loss(spec, net, p, target, batch, weights, key)
    return out.loss, out.priorities

  return jax.value_and_grad(loss_fn, has_aux=True)(online)


@jax.jit
def _jax_clipped_adam_step(grads, params):
  """optax.chain(clip_by_global_norm(10), adam) from its initial state."""
  opt = jmake_optimizer(jget_agent("rainbow"))
  updates, state = opt.update(grads, opt.init(params))
  return optax.apply_updates(params, updates), state


@pytest.mark.parametrize("weight_scale,above", [(1.0, False), (400.0, True)],
                         ids=["norm_below_10", "norm_above_10"])
def test_rainbow_loss_gradients_and_clipped_step_match_jax(weight_scale,
                                                           above):
  """Loss rtol 1e-5 and priorities rtol 1e-5, atol 1e-6; every gradient
  leaf, σ included, within a relative Frobenius error of 1e-5 and
  elementwise rtol 1e-3 with atol 1e-5 of the leaf's largest magnitude
  (f32 convolutions and products summed in another order; a hidden weight's
  gradient sums 6 rows and cancels to near 0 in some entries);
  then one step of the port's clip + Adam from JAX's gradients against
  optax.chain(clip_by_global_norm(10), adam) at the Adam test's bound, rtol
  1e-6 and atol 1e-9, with the converter finding Adam's state inside the
  chain's."""
  tspec = get_agent("rainbow")
  online, target = _jax_params(0), _jax_params(1)
  rng = np.random.RandomState(10)
  b = 6
  batch = _batch(rng, b)
  weights = (rng.uniform(0.2, 1.0, b) * weight_scale).astype(np.float32)
  key = jax.random.PRNGKey(11)

  (jloss, jprio), jgrads = _jax_loss_and_grads(online, target, batch,
                                                weights, key)
  norm = float(optax.global_norm(jgrads))
  assert (norm > 10.0) == above and abs(norm - 10.0) > 1.0, norm

  tnet = tspec.make_network(tspec, 6)
  tonline = convert.params_from_jax(online, "cpu", requires_grad=True)
  out = tspec.loss(tspec, tnet, tonline, convert.params_from_jax(
      target, "cpu"), TransitionBatch(*(_t(v) for v in batch)),
                   _t(weights), *_jax_loss_noise(key, 6, 51))
  np.testing.assert_allclose(float(out.loss.detach()), float(jloss),
                             rtol=1e-5)
  assert not out.priorities.requires_grad
  np.testing.assert_allclose(out.priorities.numpy(), np.asarray(jprio),
                             rtol=1e-5, atol=1e-6)
  grads = torch.autograd.grad(out.loss, leaves(tonline))
  jleaves = jax.tree.leaves(jgrads)
  assert len(grads) == len(jleaves) == 20
  for g, w in zip(grads, jleaves):
    w = np.asarray(w)
    assert np.linalg.norm(g.numpy() - w) <= 1e-5 * np.linalg.norm(w)
    np.testing.assert_allclose(g.numpy(), w, rtol=1e-3,
                               atol=1e-5 * float(np.abs(w).max()))

  jnew, jstate = _jax_clipped_adam_step(jgrads, online)
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
  for a, w in zip(tstate.mu + tstate.nu, conv.mu + conv.nu):
    np.testing.assert_allclose(a.numpy(), w.numpy(), rtol=1e-6, atol=1e-12)


# --- rainbow/catch supersteps ------------------------------------------------------


def _engines():
  overrides = dict(target_network_update_period=400)
  jspec = dataclasses.replace(jget_agent("rainbow"), **overrides)
  tspec = dataclasses.replace(get_agent("rainbow"), **overrides)
  # Parity mode as build_engine sets it up for 4 streams, cut to batch 8:
  # two SGD steps per superstep.
  common = dict(game="catch", num_envs=4, slots_per_stream=24, batch_size=8,
                learn_every=1, updates_per_learn=2, total_train_frames=4_000)
  return (JEngine(JEngineConfig(agent=jspec, **common)),
          Engine(EngineConfig(agent=tspec, **common), device="cpu"))


def jax_rainbow_draws(jeng, jstate,
                      env_draws=jax_catch_env_draws) -> SuperstepDraws:
  """The draws JAX's Engine.superstep makes from jstate.rng for rainbow:
  greedy_noisy_act's noise and ε draws, each SGD step's replay streams
  and rainbow_loss's three noise sets; `env_draws(env state)` gives the
  game's."""
  cfg = jeng.config
  a, atoms = jeng.game.num_actions, jeng.spec.num_atoms
  _, act_key, learn_key = jax.random.split(jstate.rng, 3)
  apply_key, policy_key = jax.random.split(act_key)
  explore_key, uniform_key = jax.random.split(policy_key)
  b = cfg.num_envs
  sample_u, loss_noise = [], []
  for k in jax.random.split(learn_key, cfg.updates_per_learn):
    sample_key, loss_key = jax.random.split(k)
    sample_u.append(_jax_sample_uniforms(sample_key, cfg.batch_size))
    loss_noise.append(_jax_loss_noise(loss_key, a, atoms))
  stacked = tuple(nets.RainbowNoise(*(torch.stack([u[j][f] for u in
                                                   loss_noise])
                                      for f in range(8)))
                  for j in range(3))
  return SuperstepDraws(
      _t(jax.random.uniform(explore_key, (b,))),
      _t(jax.random.randint(uniform_key, (b,), 0, a)),
      _t(np.stack(sample_u)), env_draws(jstate.env),
      act_noise=jax_noise(apply_key, a, atoms), loss_noise=stacked)


def test_rainbow_catch_supersteps_match_jax():
  """n-step 3 under prioritized replay, two SGD steps a superstep. JAX's
  engine drops the max-seen priority (see test_torch_prioritized.py), so
  its value tree and max are loaded into the port before each superstep.
  Bounds as test_prioritized_catch_supersteps_match_jax's: rows, the
  indicator tree, the game state and the frame count exact; frames within
  K2's ±1; the value tree exact at leaves no write touched, written ones as
  priorities within 1e-5; loss rtol 1e-3; parameters within 5e-5, 99.9 %
  of them within 2e-6."""
  jeng, teng = _engines()
  # Through the host, so that no leaf is weakly typed (the superstep's
  # outputs are not, and a second compile would follow).
  jstate = jax.device_put(jax.device_get(jax.jit(jeng.init)(
      jax.random.PRNGKey(2))))
  tstate = convert.engine_state_from_jax(teng, jax.device_get(jstate))
  jstep = jax.jit(jeng.superstep)
  learned, moved, updated = 0, 0, 0
  for step in range(8):
    jprev = jax.device_get(jstate)
    draws = jax_rainbow_draws(jeng, jprev)
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
    updated += int((got != before).sum())
    # Priorities are clipped to [0, 100]: leaves (priority^0.5) to [0, 10].
    assert float(got.max()) <= 10.0

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
  assert learned >= 4 and moved >= 2 and updated > 0
  assert isinstance(tstate.opt_state, AdamState)
  assert int(tstate.opt_state.count) == learned


# --- the runner --------------------------------------------------------------------


def test_rainbow_runner_trains_on_cpu(tmp_path):
  path = tmp_path / "r.csv"
  run_agent("rainbow", ["--device=cpu", "--environment_name=catch",
                        "--num_envs=2", "--replay_capacity=64",
                        "--min_replay_capacity_fraction=0.1",
                        "--batch_size=8", "--num_iterations=1",
                        "--num_train_frames=64", "--num_eval_frames=32",
                        "--max_frames_per_episode=16",
                        f"--results_csv_path={path}"])
  rows = list(csv.DictReader(open(path)))
  assert [int(r["iteration"]) for r in rows] == [0, 1]
  assert float(rows[1]["train_num_episodes"]) > 0
  assert rows[1]["train_state_value"] != "nan"
  assert float(rows[1]["train_exploration_epsilon"]) == 0.0
