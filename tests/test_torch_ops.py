"""Differential tests of the port's small pieces against the JAX package:
schedules, policy, value-learning ops, centered RMSProp and one DQN
loss + grad + update step from converted parameters (CPU)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dqn_zoo_tpu import ops as jops
from dqn_zoo_tpu.agents import get_agent as jget_agent
from dqn_zoo_tpu.agents.base import make_optimizer as jmake_optimizer
from dqn_zoo_tpu.replay.device_replay import TransitionBatch as JBatch
from dqn_zoo_tpu.utils.schedules import linear_schedule as jschedule
from dqn_zoo_torch import convert, ops
from dqn_zoo_torch.agents import get_agent, make_optimizer
from dqn_zoo_torch.engine.superstep import leaves
from dqn_zoo_torch.replay.device_replay import TransitionBatch
from dqn_zoo_torch.utils.schedules import linear_schedule
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def test_linear_schedule_matches_jax():
  t = np.array([-5, 0, 10, 333, 999, 1000, 5000], np.float32)
  kw = dict(begin_value=1.0, end_value=0.1, begin_t=10, end_t=1000)
  np.testing.assert_array_equal(
      linear_schedule(torch.from_numpy(t), **kw).numpy(),
      np.asarray(jschedule(jnp.asarray(t), **kw)))


@pytest.mark.parametrize("epsilon", [0.0, 0.3, 1.0])
def test_epsilon_greedy_with_jax_draws(epsilon):
  """The port decides from the draws JAX made with the same key splits."""
  key = jax.random.PRNGKey(7)
  q = np.random.RandomState(0).randn(64, 6).astype(np.float32)
  want = np.asarray(jops.epsilon_greedy_sample(key, jnp.asarray(q), epsilon))
  explore_key, uniform_key = jax.random.split(key)
  a = np.asarray(jax.random.randint(uniform_key, (64,), 0, 6))
  u = np.asarray(jax.random.uniform(explore_key, (64,)))
  got = ops.epsilon_greedy_sample(torch.from_numpy(q), epsilon,
                                  torch.from_numpy(u.copy()),
                                  torch.from_numpy(a.copy()))
  np.testing.assert_array_equal(got.numpy(), want)
  np.testing.assert_array_equal(ops.greedy_sample(torch.from_numpy(q)).numpy(),
                                np.asarray(jops.greedy_sample(q)))


def test_q_learning_and_double_q_match_jax():
  rng = np.random.RandomState(1)
  q_tm1, q_t, q_sel = (rng.randn(16, 6).astype(np.float32) for _ in range(3))
  a = rng.randint(0, 6, 16).astype(np.int32)
  r = rng.randn(16).astype(np.float32)
  d = rng.uniform(0, 1, 16).astype(np.float32)
  t = lambda x: torch.as_tensor(np.array(x))
  np.testing.assert_array_equal(
      ops.batch_q_learning(t(q_tm1), t(a), t(r), t(d), t(q_t)).numpy(),
      np.asarray(jops.batch_q_learning(q_tm1, a, r, d, q_t)))
  np.testing.assert_array_equal(
      ops.batch_double_q_learning(t(q_tm1), t(a), t(r), t(d), t(q_t),
                                  t(q_sel)).numpy(),
      np.asarray(jops.batch_double_q_learning(q_tm1, a, r, d, q_t, q_sel)))
  np.testing.assert_array_equal(
      ops.q_learning(t(q_tm1[0]), int(a[0]), t(r[0]), t(d[0]),
                     t(q_t[0])).numpy(),
      np.asarray(jops.q_learning(q_tm1[0], a[0], r[0], d[0], q_t[0])))


def test_clip_gradient_and_l2_match_jax():
  x = np.linspace(-3, 3, 13).astype(np.float32)
  jg = jax.grad(lambda v: jnp.sum(jops.l2_loss(
      jops.clip_gradient(v, -1.0, 1.0)) * 3.0))(jnp.asarray(x))
  tx = torch.from_numpy(x).requires_grad_(True)
  (ops.l2_loss(ops.clip_gradient(tx, -1.0, 1.0)) * 3.0).sum().backward()
  np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(jg))


def test_huber_loss_matches_jax():
  x = np.linspace(-3, 3, 25).astype(np.float32)
  for delta in (1.0, 0.5):
    np.testing.assert_allclose(
        ops.huber_loss(torch.from_numpy(x), delta).numpy(),
        np.asarray(jops.huber_loss(jnp.asarray(x), delta)), rtol=1e-6)


@pytest.mark.parametrize("huber_param", [0.0, 1.0])
def test_quantile_regression_loss_matches_jax(huber_param):
  rng = np.random.RandomState(5)
  src = rng.randn(9).astype(np.float32)
  tau = rng.uniform(size=9).astype(np.float32)
  tgt = rng.randn(7).astype(np.float32)
  want, jg = jax.value_and_grad(
      lambda d: jops.quantile_regression_loss(d, tau, tgt, huber_param))(src)
  tsrc = torch.from_numpy(src).requires_grad_(True)
  ttgt = torch.from_numpy(tgt).requires_grad_(True)
  got = ops.quantile_regression_loss(tsrc, torch.from_numpy(tau), ttgt,
                                     huber_param)
  assert got.dim() == 0
  np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
  g_src, g_tgt = torch.autograd.grad(got, [tsrc, ttgt], allow_unused=True)
  np.testing.assert_allclose(g_src.numpy(), np.asarray(jg), rtol=1e-5,
                             atol=1e-7)
  assert g_tgt is None  # the target is detached


@pytest.mark.parametrize("huber_param", [0.0, 1.0])
def test_batch_quantile_q_learning_matches_jax(huber_param):
  rng = np.random.RandomState(6)
  b, n, m, a = 5, 8, 6, 4
  dist_tm1 = rng.randn(b, n, a).astype(np.float32)
  tau = rng.uniform(size=(b, n)).astype(np.float32)
  a_tm1 = rng.randint(0, a, b).astype(np.int32)
  r = rng.choice([-1.0, 0.0, 1.0], b).astype(np.float32)
  disc = (0.99 * rng.randint(0, 2, b)).astype(np.float32)
  dist_sel = rng.randn(b, 7, a).astype(np.float32)
  dist_t = rng.randn(b, m, a).astype(np.float32)
  fn = lambda d: jops.batch_quantile_q_learning(
      d, tau, a_tm1, r, disc, dist_sel, dist_t, huber_param)
  want = fn(dist_tm1)
  jg = jax.grad(lambda d: jnp.sum(fn(d) * jnp.arange(1.0, b + 1)))(dist_tm1)
  t = lambda x: torch.as_tensor(np.array(x))
  td = t(dist_tm1).requires_grad_(True)
  got = ops.batch_quantile_q_learning(td, t(tau), t(a_tm1), t(r), t(disc),
                                      t(dist_sel), t(dist_t), huber_param)
  assert tuple(got.shape) == (b,)
  np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                             rtol=1e-5)
  (g,) = torch.autograd.grad((got * torch.arange(1.0, b + 1)).sum(), [td])
  np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-7)
  # One sample through the unbatched function is the batch's entry.
  one = ops.quantile_q_learning(t(dist_tm1[2]), t(tau[2]), int(a_tm1[2]),
                                t(r[2]), t(disc[2]), t(dist_sel[2]),
                                t(dist_t[2]), huber_param)
  np.testing.assert_allclose(float(one), float(want[2]), rtol=1e-5)


def test_quantile_q_learning_selects_by_the_mean_over_tau():
  """The selector's mean over its tau axis picks a_t, not any one sample."""
  sel = torch.tensor([[5.0, 0.0], [-9.0, 0.0], [1.0, 0.0]])  # mean: -1, 0
  dist_t = torch.tensor([[100.0, 2.0], [100.0, 4.0]])
  src = torch.zeros((1, 2))
  tau = torch.full((1,), 0.5)
  got = ops.quantile_q_learning(src, tau, 0, torch.tensor(1.0),
                                torch.tensor(0.5), sel, dist_t, 0.0)
  # targets 1 + 0.5 * {2, 4} = {2, 3}; |delta| weighted by 0.5: mean 1.25.
  np.testing.assert_allclose(float(got), 1.25, rtol=1e-6)


def _jax_dqn_params(seed=0):
  spec = jget_agent("dqn")
  net = spec.make_network(spec, 6)
  return jax.device_get(net.init(jax.random.PRNGKey(seed),
                                 jnp.zeros((1, 84, 84, 4), jnp.uint8)))


def test_centered_rmsprop_steps_match_optax():
  """Two steps from zero moments, with gradients spanning the regime where
  eps inside the root matters (tiny gradients)."""
  spec = jget_agent("dqn")
  params = _jax_dqn_params()
  rng = np.random.RandomState(3)
  jopt = jmake_optimizer(spec)
  jstate = jopt.init(params)
  tparams = convert.params_from_jax(params, "cpu")
  topt = make_optimizer(get_agent("dqn"))
  tstate = topt.init(leaves(tparams))
  jp = params
  for step in range(2):
    scale = 10.0 ** rng.uniform(-6, 0, size=())
    grads = jax.tree.map(
        lambda p: (rng.randn(*p.shape) * scale).astype(np.float32), params)
    updates, jstate = jopt.update(grads, jstate)
    jp = optax.apply_updates(jp, updates)
    topt.step(leaves(tparams),
              leaves(convert.params_from_jax(grads, "cpu")), tstate)
  for a, b in zip(leaves(tparams), jax.tree.leaves(jp)):
    # rsqrt may differ in the last bit between XLA and torch on the CPU.
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                               atol=1e-9)
  conv = convert.opt_state_from_jax(jstate, "cpu")
  for a, b in zip(tstate.nu + tstate.mu, conv.nu + conv.mu):
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-12)


def test_dqn_loss_grad_update_step_matches_jax():
  spec = jget_agent("dqn")
  net = spec.make_network(spec, 6)
  online = _jax_dqn_params(0)
  target = _jax_dqn_params(1)
  rng = np.random.RandomState(4)
  b = 8
  batch = JBatch(
      s_tm1=rng.randint(0, 256, (b, 84, 84, 4)).astype(np.uint8),
      a_tm1=rng.randint(0, 6, b).astype(np.int32),
      r_t=rng.choice([-1.0, 0.0, 1.0], b).astype(np.float32),
      discount_t=(0.99 * rng.randint(0, 2, b)).astype(np.float32),
      s_t=rng.randint(0, 256, (b, 84, 84, 4)).astype(np.uint8))
  weights = np.ones((b,), np.float32)

  def loss_fn(p):
    return spec.loss(spec, net, p, target, batch, weights,
                     jax.random.PRNGKey(0)).loss

  jloss, jgrads = jax.value_and_grad(loss_fn)(online)
  jopt = jmake_optimizer(spec)
  updates, _ = jopt.update(jgrads, jopt.init(online))
  jnew = optax.apply_updates(online, updates)

  tspec = get_agent("dqn")
  tnet = tspec.make_network(tspec, 6)
  tonline = convert.params_from_jax(online, "cpu", requires_grad=True)
  ttarget = convert.params_from_jax(target, "cpu")
  tbatch = TransitionBatch(*(torch.from_numpy(np.asarray(x)) for x in batch))
  out = tspec.loss(tspec, tnet, tonline, ttarget, tbatch,
                   torch.from_numpy(weights))
  # f32 convolutions summed in another order.
  np.testing.assert_allclose(float(out.loss.detach()), float(jloss),
                             rtol=1e-5)
  grads = torch.autograd.grad(out.loss, leaves(tonline))
  for a, g in zip(grads, jax.tree.leaves(jgrads)):
    np.testing.assert_allclose(a.numpy(), np.asarray(g), rtol=1e-3,
                               atol=1e-7)
  topt = make_optimizer(tspec)
  topt.step(leaves(tonline), list(grads), topt.init(leaves(tonline)))
  for a, p in zip(leaves(tonline), jax.tree.leaves(jnew)):
    # One step moves a weight by at most ~lr·4.6; gradient noise of 1e-7
    # relative moves it far less.
    np.testing.assert_allclose(a.detach().numpy(), np.asarray(p), rtol=0,
                               atol=1e-6)


def test_optimizers_not_ported_yet_raise():
  """An unknown optimizer raises; Adam is ported (tests/test_torch_iqn.py
  holds it against optax.adam); a global-norm clip wraps either optimizer
  and steps as optax.chain(clip_by_global_norm(10), optimizer) does, for
  gradients of global norm above 10 and below: rtol 1e-6, atol 1e-9, the
  bound of the Adam test."""
  spec = get_agent("dqn")
  with pytest.raises(ValueError):
    make_optimizer(dataclasses.replace(spec, optimizer="sgd"))
  assert type(make_optimizer(dataclasses.replace(
      spec, optimizer="adam"))).__name__ == "Adam"
  rng = np.random.RandomState(12)
  params = {"a": {"w": rng.randn(5, 3).astype(np.float32),
                  "b": rng.randn(3).astype(np.float32)},
            "c": rng.randn(7).astype(np.float32)}
  for optimizer in ("rmsprop", "adam"):
    clipped = dataclasses.replace(spec, optimizer=optimizer,
                                  max_global_grad_norm=10.0)
    jopt = jmake_optimizer(clipped)
    jstate = jopt.init(params)
    topt = make_optimizer(clipped)
    tparams = convert.params_from_jax(params, "cpu")
    tstate = topt.init(leaves(tparams))
    jp = params
    for scale in (10.0, 0.5, 3.0, 0.01):  # global norms ~45, 2, 13, 0.05
      grads = jax.tree.map(
          lambda p: (rng.randn(*p.shape) * scale).astype(np.float32), params)
      norm = float(optax.global_norm(grads))
      assert abs(norm - 10.0) > 1.0
      updates, jstate = jopt.update(grads, jstate)
      jp = optax.apply_updates(jp, updates)
      topt.step(leaves(tparams),
                leaves(convert.params_from_jax(grads, "cpu")), tstate)
    for a, b in zip(leaves(tparams), jax.tree.leaves(jp)):
      np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                 atol=1e-9, err_msg=optimizer)
