"""Differential tests of the port's iqn/pong learn step (CPU).

The fused IQN head's backward in its plain version (the arithmetic of
kernels K4b and K4c, and the backward assembled from them) against the
reference's Pallas kernels in interpret mode, jax.grad of its XLA oracle
and autograd through the port's plain forward; `iqn_loss` against the JAX
loss with the τ samples the JAX loss draws from its key; several learning
supersteps of both engines from one JAX state; the loss τ draws of the
engine; the CLI taking learn steps. Inputs come from numpy seeds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_iqn import (D, H, L, ORDER, _act_draws, _cli, _engines,
                            _head_inputs, _jax_iqn_params, _t)
from test_torch_slice import _assert_u8_close, jax_env_draws

from dqn_zoo_tpu.agents import get_agent as jget_agent
from dqn_zoo_tpu.nets import iqn_head as jhead
from dqn_zoo_tpu.replay.device_replay import TransitionBatch as JBatch
from dqn_zoo_torch import convert
from dqn_zoo_torch.agents import AdamState, get_agent
from dqn_zoo_torch.engine import SuperstepDraws
from dqn_zoo_torch.engine.superstep import leaves
from dqn_zoo_torch.nets import iqn_head as thead
from dqn_zoo_torch.replay.device_replay import TransitionBatch
from dqn_zoo_torch.run import train as ttrain
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

BWD_OUTPUTS = ("dwh", "dbh", "dwe", "dbe", "ds_emb", "dcos")


def _dh(rows, seed):
  """A cotangent of the hidden pre-activation, masked as h > 0 masks it."""
  rng = np.random.RandomState(seed)
  return (rng.randn(rows, H) * (rng.rand(rows, H) > 0.4)).astype(np.float32)


# --- K4b and K4c: the plain versions against the reference's kernels -----------


@pytest.mark.parametrize("name", BWD_OUTPUTS)
def test_head_bwd_plain_matches_the_pallas_kernels(name):
  b, s = 8, 8
  args = _head_inputs(b, s, 6, seed=10)
  dh = _dh(b * s, seed=11)
  cos2 = args["cos_emb"].reshape(b * s, L)
  we, be, wh, s_emb = (args[k] for k in ("we", "be", "wh", "s_emb"))
  t = {k: _t(v) for k, v in args.items()}
  if name in ("dwh", "dbh"):
    want = jhead._bwd_w_call(we, be, cos2, s_emb, dh, True, jnp.float32)
    got = thead.iqn_head_bwd_w_plain(t["we"], t["be"], t["cos_emb"],
                                     t["s_emb"], _t(dh))
    i = ("dwh", "dbh").index(name)
  else:
    want = jhead._bwd_d_call(we, be, wh, cos2, s_emb, dh, True, jnp.float32)
    got = thead.iqn_head_bwd_d_plain(t["we"], t["be"], t["wh"], t["cos_emb"],
                                     t["s_emb"], _t(dh))
    i = ("dwe", "dbe", "ds_emb", "dcos").index(name)
  shapes = dict(dwh=(D, H), dbh=(H,), dwe=(L, D), dbe=(D,), ds_emb=(b, D),
                dcos=(b, s, L))
  assert tuple(got[i].shape) == shapes[name]
  # f32 on both sides; the products sum in another order.
  np.testing.assert_allclose(
      got[i].numpy().reshape(-1), np.asarray(want[i]).reshape(-1), rtol=1e-4,
      atol=1e-5, err_msg=name)


def test_head_bwd_d_plain_without_dcos_and_with_a_given_mask():
  b, s = 2, 4
  args = {k: _t(v) for k, v in _head_inputs(b, s, 6, seed=12).items()}
  pos = (args["we"], args["be"], args["wh"], args["cos_emb"], args["s_emb"],
         _t(_dh(b * s, seed=13)))
  full = thead.iqn_head_bwd_d_plain(*pos)
  none = thead.iqn_head_bwd_d_plain(*pos, need_dcos=False)
  assert none[3] is None
  for a, w in zip(none[:3], full[:3]):
    assert torch.equal(a, w)
  # Its own te_pre > 0 handed back in gives the same result; all-zero bits
  # leave only ds_emb, which reads te and not the mask.
  te_pre = args["cos_emb"].reshape(b * s, L) @ args["we"] + args["be"]
  same = thead.iqn_head_bwd_d_plain(*pos, te_mask=(te_pre > 0).to(torch.uint8))
  for a, w in zip(same, full):
    assert torch.equal(a, w)
  zero = thead.iqn_head_bwd_d_plain(
      *pos, te_mask=torch.zeros((b * s, D), dtype=torch.uint8))
  assert not bool(zero[0].any()) and not bool(zero[3].any())
  assert torch.equal(zero[2], full[2])


def _assembled(args, w):
  """The body the autograd Function's backward runs, on the plain versions:
  {argument name: gradient of sum(q * w)}."""
  pos = [_t(args[k]) for k in ORDER]
  _, h = thead.iqn_head_plain_residuals(*pos)
  we, be, wh, _, wo, _, cos_emb, s_emb = pos
  grads = thead.iqn_head_backward(
      we, be, wh, wo, cos_emb, s_emb, h, _t(w), thead.iqn_head_bwd_w_plain,
      thead.iqn_head_bwd_d_plain)
  return dict(zip(ORDER, grads))


@pytest.mark.parametrize("name", ORDER)
def test_head_assembled_backward_matches_jax_grad(name):
  """The wo-layer ops plus the two plain backward functions against jax.grad
  of the XLA oracle, for each of the eight arguments."""
  b, s, a = 8, 16, 6
  args = _head_inputs(b, s, a, seed=2)
  w = np.random.RandomState(3).randn(b, s, a).astype(np.float32)
  pos = tuple(args[k] for k in ORDER)
  i = ORDER.index(name)
  want = jax.grad(lambda *p: jnp.sum(jhead.iqn_head_xla(*p) * w), i)(*pos)
  got = _assembled(args, w)[name]
  assert tuple(got.shape) == want.shape
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                             atol=2e-4, err_msg=name)


@pytest.mark.parametrize("name", ORDER)
def test_head_assembled_backward_matches_autograd_at_a_ragged_shape(name):
  """B = 3, S = 5: a shape the reference's kernels refuse."""
  b, s, a = 3, 5, 4
  assert not jhead.fused_shapes_ok(b, s)
  args = _head_inputs(b, s, a, seed=14)
  w = np.random.RandomState(15).randn(b, s, a).astype(np.float32)
  i = ORDER.index(name)
  tpos = [_t(args[k], grad=(j == i)) for j, k in enumerate(ORDER)]
  (want,) = torch.autograd.grad(
      (thead.iqn_head_plain(*tpos) * torch.from_numpy(w)).sum(), [tpos[i]])
  got = _assembled(args, w)[name]
  np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-5,
                             err_msg=name)


def test_head_bwd_wrappers_refuse_what_the_kernels_do_not_take():
  b, s = 2, 8
  args = {k: _t(v) for k, v in _head_inputs(b, s, 6, seed=16).items()}
  dh = _t(_dh(b * s, seed=17))
  w_pos = dict(we=args["we"], be=args["be"], cos_emb=args["cos_emb"],
               s_emb=args["s_emb"], dh=dh)
  bwd_w = lambda **kw: thead.iqn_head_bwd_w(*{**w_pos, **kw}.values())
  with pytest.raises(ValueError, match="shape"):
    bwd_w(dh=dh[:-1])
  with pytest.raises(ValueError, match="float32"):
    bwd_w(dh=dh.double())
  with pytest.raises(ValueError, match="contiguous"):
    bwd_w(dh=dh.t().contiguous().t())
  # All in order but on the CPU: the kernel wrappers never take the plain
  # versions; only `iqn_head` does, through autograd of the plain forward.
  before = (thead.BWD_W.launches, thead.BWD_D.launches)
  with pytest.raises(ValueError, match="CUDA"):
    bwd_w()
  with pytest.raises(ValueError, match="CUDA"):
    thead.iqn_head_bwd_d(args["we"], args["be"], args["wh"], args["cos_emb"],
                         args["s_emb"], dh)
  with pytest.raises(ValueError, match="shape"):
    thead.iqn_head_bwd_d(args["we"], args["be"], args["wh"][:, :-1],
                         args["cos_emb"], args["s_emb"], dh)
  pos = [args[k].clone().requires_grad_(True) for k in ORDER]
  thead.iqn_head(*pos).sum().backward()
  assert all(p.grad is not None for p in pos)
  assert (thead.BWD_W.launches, thead.BWD_D.launches) == before


def test_head_bwd_bound_counts_at_the_learn_shape():
  rows = 1024 * 64
  nbytes, flops = thead.bound_counts_bwd_w(1024, 64)
  assert flops == 2 * rows * (64 * 3136 + 3136 * 512)
  # cos 16.8 MB, dh 134 MB, s_emb 12.8 MB, dwh 6.4 MB, we 0.8 MB.
  assert 170e6 < nbytes < 172e6
  nbytes_c, flops_c = thead.bound_counts_bwd_d(1024, 64, need_dcos=True)
  assert flops_c == 2 * rows * (3 * 64 * 3136 + 3136 * 512)
  less, fewer = thead.bound_counts_bwd_d(1024, 64, need_dcos=False)
  assert nbytes_c - less == rows * 64 * 4
  assert flops_c - fewer == 2 * rows * 64 * 3136


def test_head_bwd_row_groups_hold_whole_streams():
  """The grid's second axis: at most 4 groups, never more than streams, each
  of at least 1024 rows."""
  assert thead.row_groups(1024, 64) == 4 and thead.row_groups(128, 64) == 4
  assert thead.row_groups(4, 64) == 1 and thead.row_groups(3, 24) == 1
  assert thead.row_groups(5, 512) == 2 and thead.row_groups(3, 4096) == 3
  assert thead.row_groups(1, 8192) == 1


# --- the loss --------------------------------------------------------------------


def _loss_taus(loss_key, b, n):
  """The three tau sets JAX's iqn_loss draws from its key."""
  _, k_tm1, k_sel, k_t = jax.random.split(loss_key, 4)
  return tuple(_t(jax.random.uniform(k, (b, n))) for k in (k_tm1, k_sel, k_t))


def test_iqn_loss_and_gradients_match_jax():
  n = 8
  overrides = dict(tau_samples_policy=n, tau_samples_s_tm1=n,
                   tau_samples_s_t=n)
  jspec = dataclasses.replace(jget_agent("iqn"), **overrides)
  tspec = dataclasses.replace(get_agent("iqn"), **overrides)
  jnet, online = _jax_iqn_params(seed=0)
  _, target = _jax_iqn_params(seed=1)
  rng = np.random.RandomState(20)
  b = 6
  batch = JBatch(
      s_tm1=rng.randint(0, 256, (b, 84, 84, 4)).astype(np.uint8),
      a_tm1=rng.randint(0, 6, b).astype(np.int32),
      r_t=rng.choice([-1.0, 0.0, 1.0], b).astype(np.float32),
      discount_t=(0.99 * rng.randint(0, 2, b)).astype(np.float32),
      s_t=rng.randint(0, 256, (b, 84, 84, 4)).astype(np.uint8))
  weights = rng.uniform(0.5, 1.5, b).astype(np.float32)
  key = jax.random.PRNGKey(21)

  def loss_fn(p):
    out = jspec.loss(jspec, jnet, p, target, batch, weights, key)
    return out.loss, out.priorities

  (jloss, jprio), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(online)

  tnet = tspec.make_network(tspec, 6)
  tonline = convert.params_from_jax(online, "cpu", requires_grad=True)
  ttarget = convert.params_from_jax(target, "cpu")
  tbatch = TransitionBatch(*(torch.from_numpy(np.asarray(x)) for x in batch))
  out = tspec.loss(tspec, tnet, tonline, ttarget, tbatch,
                   torch.from_numpy(weights), *_loss_taus(key, b, n))
  assert not out.priorities.requires_grad
  assert tuple(out.priorities.shape) == (b,)
  # f32 convolutions and products summed in another order.
  np.testing.assert_allclose(float(out.loss.detach()), float(jloss),
                             rtol=1e-4, atol=1e-6)
  np.testing.assert_allclose(out.priorities.numpy(), np.asarray(jprio),
                             rtol=1e-4, atol=1e-6)
  grads = torch.autograd.grad(out.loss, leaves(tonline))
  assert len(grads) == 12
  for g, w in zip(grads, jax.tree.leaves(jgrads)):
    np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                               atol=1e-6)


# --- the slice: learning supersteps of both engines ------------------------------


def _learn_draws(jeng, js):
  """The draws JAX's Engine.superstep makes from js.rng for an iqn learning
  superstep: iqn_act's, the replay sample's and iqn_loss's."""
  cfg, spec = jeng.config, jeng.spec
  assert cfg.updates_per_learn == 1
  _, act_key, learn_key = jax.random.split(js.rng, 3)
  explore_u, random_action, act_taus = _act_draws(
      act_key, cfg.num_envs, spec.tau_samples_policy)
  sample_key, loss_key = jax.random.split(learn_key)
  u_key = jax.random.split(sample_key, 3)[0]
  sample_u = _t(jax.random.uniform(u_key, (cfg.batch_size,)))[None]
  loss_taus = tuple(x[None] for x in _loss_taus(
      loss_key, cfg.batch_size, spec.tau_samples_s_tm1))
  return SuperstepDraws(explore_u, random_action, sample_u,
                        jax_env_draws(js.env), act_taus, loss_taus)


def test_iqn_slice_learning_supersteps_match_jax():
  jeng, teng = _engines(min_replay_capacity_fraction=0.05,
                        target_network_update_period=48)
  jstate = jeng.init(jax.random.PRNGKey(0))
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
    assert tstate.env_frames == ref.env_frames
    assert tstate.telemetry.learn_steps == ref.telemetry.learn_steps
    if ref.telemetry.learn_steps:
      np.testing.assert_allclose(float(tstate.telemetry.last_loss),
                                 float(ref.telemetry.last_loss), rtol=1e-3)
    # Parameters and Adam's state: f32 on both sides, with the few ±1
    # observation pixels feeding the nets.
    for tree, ref_tree in ((tstate.online_params, ref.online_params),
                           (tstate.target_params, ref.target_params)):
      for a, w in zip(leaves(tree), leaves(ref_tree)):
        np.testing.assert_allclose(a.detach().numpy(), w.detach().numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=str(step))
    assert isinstance(tstate.opt_state, AdamState)
    assert int(tstate.opt_state.count) == int(ref.opt_state.count) == \
        ref.telemetry.learn_steps
    for a, w in zip(tstate.opt_state.mu + tstate.opt_state.nu,
                    ref.opt_state.mu + ref.opt_state.nu):
      np.testing.assert_allclose(a.numpy(), w.numpy(), rtol=1e-4, atol=1e-6,
                                 err_msg=str(step))
    swaps += any(not torch.equal(a, b) for a, b in
                 zip(prev_target, leaves(tstate.target_params)))
  assert ref.telemetry.learn_steps >= 4 and swaps >= 1
  assert np.isfinite(float(tstate.telemetry.last_loss))


def test_engine_draws_loss_taus_only_for_iqn_when_learning():
  _, ieng = _engines()
  d = ieng.draw(torch.Generator().manual_seed(0))
  assert len(d.loss_taus) == 3
  for t in d.loss_taus:  # (updates, batch, n), one set per update
    assert tuple(t.shape) == (1, 8, 8)
    assert float(t.min()) >= 0.0 and float(t.max()) < 1.0
  assert not torch.equal(d.loss_taus[0], d.loss_taus[1])
  # They are drawn after sample_u, which stays what it was without them.
  gen = torch.Generator().manual_seed(0)
  torch.rand((4,), generator=gen)
  torch.randint(0, 6, (4,), generator=gen)
  torch.rand((4, 8), generator=gen)  # act_taus
  torch.testing.assert_close(d.sample_u, torch.rand((1, 8), generator=gen))
  torch.testing.assert_close(d.loss_taus[0],
                             torch.rand((1, 8, 8), generator=gen))
  e = ieng.draw(torch.Generator().manual_seed(0), ieng._eval_env(2),
                learn=False)
  assert e.loss_taus is None and e.sample_u is None
  deng = ttrain.build_engine("dqn", "pong", num_envs=4, replay_capacity=64,
                             device="cpu")
  assert deng.draw(torch.Generator().manual_seed(0)).loss_taus is None
  assert get_agent("iqn").loss_takes_taus
  assert not get_agent("dqn").loss_takes_taus


# --- the CLI ---------------------------------------------------------------------


def test_cli_iqn_takes_learn_steps_and_writes_a_finite_loss(tmp_path,
                                                            monkeypatch):
  """--replay_capacity=64: the min fill of 2 % is passed at once, so the
  train phase of iteration 1 learns."""
  seen = []
  metrics = ttrain.Engine.metrics

  def spy(self, state):
    seen.append(metrics(self, state))
    return seen[-1]

  monkeypatch.setattr(ttrain.Engine, "metrics", spy)
  _cli(tmp_path, "--replay_capacity=64", "--batch_size=4")
  rows = (tmp_path / "r.csv").read_text().strip().splitlines()
  assert len(rows) == 3  # header, iteration 0 (eval only), iteration 1
  assert seen[-1].learn_steps >= 4
  assert np.isfinite(seen[-1].last_loss)
