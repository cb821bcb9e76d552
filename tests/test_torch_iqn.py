"""Differential tests of the port's iqn/pong acting and eval path (CPU).

The fused IQN head's plain version against the reference's XLA oracle and
its Pallas kernel in interpret mode (forward, and gradients as the reference
for the backward kernels still to come), the IQN network, Adam against
optax.adam, the optimizer-state converter, iqn_act, and several supersteps
and eval supersteps of both engines from one JAX state carried across by
dqn_zoo_torch.convert. Inputs come from numpy seeds; JAX's random draws are
repeated from its keys and handed to the port (see test_torch_slice.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_slice import _assert_u8_close, jax_env_draws

from dqn_zoo_tpu import nets as jnets
from dqn_zoo_tpu.agents import get_agent as jget_agent
from dqn_zoo_tpu.agents.base import make_optimizer as jmake_optimizer
from dqn_zoo_tpu.engine import Engine as JEngine
from dqn_zoo_tpu.engine import EngineConfig as JEngineConfig
from dqn_zoo_tpu.envs.vector import VectorEnvConfig as JEnvConfig
from dqn_zoo_tpu.nets import iqn_head as jhead
from dqn_zoo_torch import convert, nets
from dqn_zoo_torch.agents import (AdamState, RMSPropState, all_agent_names,
                                  get_agent, make_optimizer)
from dqn_zoo_torch.engine import Engine, EngineConfig, SuperstepDraws
from dqn_zoo_torch.engine.superstep import leaves
from dqn_zoo_torch.envs.vector import VectorEnvConfig
from dqn_zoo_torch.nets import iqn_head as thead
from dqn_zoo_torch.run import train as ttrain

D, H, L = 3136, 512, 64  # the published IQN widths
ORDER = ("we", "be", "wh", "bh", "wo", "bo", "cos_emb", "s_emb")


def _head_inputs(b, s, a, seed):
  """The eight arguments, at the scale of the reference's own kernel test."""
  rng = np.random.RandomState(seed)
  n = lambda *shape: rng.randn(*shape).astype(np.float32)
  sc = 0.05
  return dict(we=n(L, D) * sc, be=n(D) * sc, wh=n(D, H) * sc * 0.3,
              bh=n(H) * sc, wo=n(H, a) * sc, bo=n(a) * sc,
              cos_emb=n(b, s, L), s_emb=np.maximum(n(b, D), 0.0))


def _t(x, **kw):
  return torch.from_numpy(np.array(x)).requires_grad_(kw.get("grad", False))


# --- the head: plain version against the reference ----------------------------


@pytest.mark.parametrize("b,s,a,oracle", [
    (8, 8, 6, "xla"), (8, 8, 6, "pallas_interpret"),
    (8, 64, 18, "xla"), (8, 64, 18, "pallas_interpret"),
    (3, 24, 4, "xla")])  # (3, 24): a shape the Pallas kernel refuses
def test_head_plain_matches_jax(b, s, a, oracle):
  args = _head_inputs(b, s, a, seed=0)
  pos = [args[k] for k in ORDER]
  if oracle == "xla":
    want = jhead.iqn_head_xla(*pos)
  else:
    assert jhead.fused_shapes_ok(b, s)
    want = jhead.iqn_head_fused(*pos, interpret=True)
  got = thead.iqn_head(*(_t(x) for x in pos))  # CPU tensors: plain version
  assert tuple(got.shape) == (b, s, a)
  # f32 on both sides; the products sum in another order.
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                             atol=1e-5)


def test_head_plain_residual_is_the_hidden_layer():
  args = _head_inputs(4, 8, 6, seed=1)
  pos = [_t(args[k]) for k in ORDER]
  q, h = thead.iqn_head_plain_residuals(*pos)
  assert tuple(h.shape) == (32, H) and bool((h >= 0).all())
  torch.testing.assert_close(q.reshape(32, 6), h @ pos[4] + pos[5])


@pytest.mark.parametrize("name", ORDER)
def test_head_plain_gradients_match_jax(name):
  """Autograd through the plain version against jax.grad of the XLA oracle,
  for each of the eight arguments: what the backward kernels are held to."""
  b, s, a = 8, 16, 6
  args = _head_inputs(b, s, a, seed=2)
  pos = tuple(args[k] for k in ORDER)
  w = np.random.RandomState(3).randn(b, s, a).astype(np.float32)
  i = ORDER.index(name)
  want = jax.grad(lambda *p: jnp.sum(jhead.iqn_head_xla(*p) * w), i)(*pos)
  tpos = [_t(x, grad=(j == i)) for j, x in enumerate(pos)]
  (got,) = torch.autograd.grad(
      (thead.iqn_head(*tpos) * torch.from_numpy(w)).sum(), [tpos[i]])
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                             atol=2e-4, err_msg=name)


def test_head_wrapper_refuses_what_the_kernel_does_not_take():
  args = _head_inputs(2, 8, 6, seed=4)
  pos = {k: _t(args[k]) for k in ORDER}
  call = lambda **kw: thead.iqn_head_forward(
      *({**pos, **kw}[k] for k in ORDER), residuals=False)
  with pytest.raises(ValueError, match="float32"):
    call(cos_emb=pos["cos_emb"].double())
  with pytest.raises(ValueError, match="contiguous"):
    call(wh=pos["wh"].t().contiguous().t())
  with pytest.raises(ValueError, match="shape"):
    call(bh=pos["bh"][:-1])
  with pytest.raises(ValueError, match="latent must be 64"):
    call(cos_emb=pos["cos_emb"][:, :, :32].contiguous(),
         we=pos["we"][:32].contiguous())
  # All in order but on the CPU: the kernel wrapper itself never takes the
  # plain version, only `iqn_head` does for CPU tensors.
  with pytest.raises(ValueError, match="CUDA"):
    call()
  before = thead.FWD.launches
  thead.iqn_head(*(pos[k] for k in ORDER))
  assert thead.FWD.launches == before  # the plain version counts no launch


def test_head_bound_counts_at_the_act_shape():
  nbytes, flops = thead.bound_counts(128, 64, 6, residuals=False)
  assert flops == 2 * 128 * 64 * (64 * 3136 + 3136 * 512 + 512 * 6)
  assert 10.5e6 < nbytes < 11.5e6
  more, same = thead.bound_counts(128, 64, 6, residuals=True)
  assert more - nbytes == 128 * 64 * 512 * 4 and same == flops


# --- the network ----------------------------------------------------------------


def _jax_iqn_params(seed=0, num_actions=6, n_taus=8):
  net = jnets.iqn_atari_network(num_actions, L)
  params = net.init(jax.random.PRNGKey(seed), jnets.IqnInputs(
      jnp.zeros((1, 84, 84, 4), jnp.uint8), jnp.zeros((1, n_taus))))
  return net, jax.device_get(params)


def test_iqn_network_apply_matches_jax():
  jnet, params = _jax_iqn_params()
  rng = np.random.RandomState(5)
  obs = rng.randint(0, 256, (5, 84, 84, 4)).astype(np.uint8)
  taus = rng.uniform(size=(5, 12)).astype(np.float32)
  want = jnet.apply(params, None, jnets.IqnInputs(obs, taus))
  tnet = nets.iqn_atari_network(6, L)
  tparams = convert.params_from_jax(params, "cpu")
  assert set(tparams) == {"torso", "tau_embed", "head"}
  with torch.no_grad():
    got = tnet.apply(tparams, nets.IqnInputs(_t(obs), _t(taus)))
  assert tuple(got.q_dist.shape) == (5, 12, 6)
  # f32 convolutions and products summed in another order; cos of arguments
  # up to 64π may differ in the last bit between XLA and torch.
  np.testing.assert_allclose(got.q_dist.numpy(), np.asarray(want.q_dist),
                             rtol=1e-4, atol=1e-5)
  np.testing.assert_allclose(got.q_values.numpy(), np.asarray(want.q_values),
                             rtol=1e-4, atol=1e-5)
  assert not got.q_values.requires_grad


def test_iqn_network_init_has_the_jax_tree_and_scales():
  _, params = _jax_iqn_params()
  gen = torch.Generator().manual_seed(0)
  tparams = nets.iqn_atari_network(6, L).init(gen, "cpu")
  # Leaf for leaf in sorted-key order (JAX's tree also holds empty dicts
  # for its parameterless layers).
  path_shapes = lambda tree: [
      (jax.tree_util.keystr(path), tuple(x.shape))
      for path, x in jax.tree_util.tree_leaves_with_path(tree)]
  assert path_shapes(params) == path_shapes(tparams)
  assert len(leaves(tparams)) == 12
  te = tparams["tau_embed"]
  bound = 1.0 / np.sqrt(L)  # fan-in = latent dim
  for leaf in (te["w"], te["b"]):
    assert float(leaf.abs().max()) <= bound
    assert float(leaf.abs().max()) > 0.9 * bound


# --- Adam and the optimizer-state converter ---------------------------------------


def _small_tree(rng):
  return {"a": {"w": rng.randn(5, 3).astype(np.float32),
                "b": rng.randn(3).astype(np.float32)},
          "c": rng.randn(7).astype(np.float32)}


def test_adam_steps_match_optax():
  spec = jget_agent("iqn")
  rng = np.random.RandomState(6)
  params = _small_tree(rng)
  jopt = jmake_optimizer(spec)
  jstate = jopt.init(params)
  tspec = get_agent("iqn")
  topt = make_optimizer(tspec)
  assert (tspec.learning_rate, tspec.optimizer_epsilon) == \
      (spec.learning_rate, spec.optimizer_epsilon)
  tparams = convert.params_from_jax(params, "cpu")
  tstate = topt.init(leaves(tparams))
  jp = params
  for _ in range(5):
    # Gradients from far below eps (0.01/32, outside the root) to above.
    scale = 10.0 ** rng.uniform(-6, 0, size=())
    grads = jax.tree.map(
        lambda p: (rng.randn(*p.shape) * scale).astype(np.float32), params)
    updates, jstate = jopt.update(grads, jstate)
    jp = optax.apply_updates(jp, updates)
    topt.step(leaves(tparams), leaves(convert.params_from_jax(grads, "cpu")),
              tstate)
  for a, b in zip(leaves(tparams), jax.tree.leaves(jp)):
    # optax takes the bias corrections in f32, the port in double.
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                               atol=1e-9)
  conv = convert.opt_state_from_jax(jax.device_get(jstate), "cpu")
  assert isinstance(conv, AdamState) and int(conv.count) == 5
  assert int(tstate.count) == 5
  for a, b in zip(tstate.nu + tstate.mu, conv.nu + conv.mu):
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-12)


@pytest.mark.parametrize("agent,state_type", [("iqn", AdamState),
                                              ("dqn", RMSPropState)])
def test_opt_state_from_jax_keeps_the_optimizers_apart(agent, state_type):
  """Both optax states hold mu and nu; Adam's also holds the step count,
  which must not be dropped by reading it as RMSProp moments."""
  rng = np.random.RandomState(7)
  params = _small_tree(rng)
  jopt = jmake_optimizer(jget_agent(agent))
  jstate = jopt.init(params)
  for _ in range(3):
    grads = jax.tree.map(lambda p: rng.randn(*p.shape).astype(np.float32),
                         params)
    _, jstate = jopt.update(grads, jstate)
  conv = convert.opt_state_from_jax(jax.device_get(jstate), "cpu")
  assert type(conv) is state_type
  assert len(conv.mu) == len(conv.nu) == 3
  if state_type is AdamState:
    assert int(conv.count) == 3 and conv.count.device.type == "cpu"
  # The converted state is one the port's optimizer can step from.
  topt = make_optimizer(get_agent(agent))
  tparams = leaves(convert.params_from_jax(params, "cpu"))
  topt.step(tparams, [torch.ones_like(p) for p in tparams], conv)


# --- the agent --------------------------------------------------------------------


def _act_draws(act_key, b, num_taus, num_actions=6):
  """What JAX's iqn_act draws from its key: it splits three ways (tau,
  apply, policy), where dqn's actor splits in two."""
  tau_key, _, policy_key = jax.random.split(act_key, 3)
  taus = jax.random.uniform(tau_key, (b, num_taus))
  explore_key, uniform_key = jax.random.split(policy_key)
  explore_u = jax.random.uniform(explore_key, (b,))
  random_action = jax.random.randint(uniform_key, (b,), 0, num_actions)
  return _t(explore_u), _t(random_action), _t(taus)


def test_iqn_spec_has_the_jax_values():
  jspec, tspec = jget_agent("iqn"), get_agent("iqn")
  for f in dataclasses.fields(tspec):
    if f.name in ("make_network", "loss", "act", "act_takes_taus"):
      continue
    assert getattr(tspec, f.name) == getattr(jspec, f.name), f.name
  assert tspec.act_takes_taus and not get_agent("dqn").act_takes_taus
  assert all_agent_names() == ["dqn", "iqn"]


@pytest.mark.parametrize("epsilon", [0.0, 0.5])
def test_iqn_act_matches_jax(epsilon):
  jspec = dataclasses.replace(jget_agent("iqn"), tau_samples_policy=8)
  tspec = dataclasses.replace(get_agent("iqn"), tau_samples_policy=8)
  jnet, params = _jax_iqn_params(seed=1)
  obs = np.random.RandomState(8).randint(0, 256, (6, 84, 84, 4)).astype(
      np.uint8)
  key = jax.random.PRNGKey(9)
  jactions, jvalues = jspec.act(jspec, jnet, params, key, obs, epsilon)
  explore_u, random_action, taus = _act_draws(key, 6, 8)
  tparams = convert.params_from_jax(params, "cpu", requires_grad=True)
  actions, values = tspec.act(
      tspec, tspec.make_network(tspec, 6), tparams, _t(obs), epsilon,
      explore_u, random_action, taus)
  np.testing.assert_array_equal(actions.numpy(), np.asarray(jactions))
  np.testing.assert_allclose(values.numpy(), np.asarray(jvalues), rtol=1e-4,
                             atol=1e-5)
  assert not values.requires_grad


def test_iqn_loss_raises_until_the_backward_kernels_are_ported():
  spec = get_agent("iqn")
  with pytest.raises(NotImplementedError, match="K4b.*K4c.*quantile"):
    spec.loss(spec, None, None, None, None, None)


# --- the slice: several supersteps of both engines ------------------------------


def _engines(num_envs=4):
  # 8 policy taus keep the test small; a min fill out of reach keeps both
  # engines on the acting path (the port's iqn loss raises).
  overrides = dict(tau_samples_policy=8, tau_samples_s_tm1=8,
                   tau_samples_s_t=8, min_replay_capacity_fraction=2.0)
  jspec = dataclasses.replace(jget_agent("iqn"), **overrides)
  tspec = dataclasses.replace(get_agent("iqn"), **overrides)
  common = dict(game="pong", num_envs=num_envs, slots_per_stream=16,
                batch_size=8, learn_every=1, updates_per_learn=1,
                total_train_frames=20_000)
  jeng = JEngine(JEngineConfig(agent=jspec, env_config=JEnvConfig(
      episode_frame_cap=36), **common))
  teng = Engine(EngineConfig(agent=tspec, env_config=VectorEnvConfig(
      episode_frame_cap=36), **common), device="cpu")
  return jeng, teng


def test_iqn_slice_supersteps_match_jax():
  jeng, teng = _engines()
  jstate = jeng.init(jax.random.PRNGKey(0))
  tstate = convert.engine_state_from_jax(teng, jax.device_get(jstate))
  assert isinstance(tstate.opt_state, AdamState)
  assert set(tstate.online_params) == {"torso", "tau_embed", "head"}
  jstep = jax.jit(jeng.superstep)
  b = jeng.config.num_envs
  for step in range(12):
    js = jax.device_get(jstate)
    _, act_key, _ = jax.random.split(js.rng, 3)
    explore_u, random_action, taus = _act_draws(act_key, b, 8)
    draws = SuperstepDraws(explore_u, random_action, None,
                           jax_env_draws(js.env), taus)
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
    _assert_u8_close(tstate.pending.frame, ref.pending.frame, step)
    for f in ("stack_count", "reward", "discount", "is_terminal"):
      assert torch.equal(getattr(tstate.pending, f), getattr(ref.pending, f))
    for name, a, w in zip(ref.env.game_state._fields, tstate.env.game_state,
                          ref.env.game_state):
      assert torch.equal(a, w), (name, step)
    assert tstate.env_frames == ref.env_frames
    # Values: the mean over tau of the head, f32 on both sides.
    np.testing.assert_allclose(float(tstate.telemetry.state_value_ewma),
                               float(ref.telemetry.state_value_ewma),
                               rtol=1e-4, atol=1e-9)
    assert tstate.telemetry.learn_steps == ref.telemetry.learn_steps == 0
  assert bool(ref.replay.is_terminal.any())  # truncations were inserted
  assert int(ref.replay.action.max()) > 0


def test_iqn_eval_supersteps_match_jax():
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
  for _ in range(10):
    je = jax.device_get(jeval)
    _, act_key = jax.random.split(je.rng)
    explore_u, random_action, taus = _act_draws(act_key, 3, 8)
    draws = SuperstepDraws(explore_u, random_action, None,
                           jax_env_draws(je.env), taus)
    jeval = jstep(params, jeval)
    teval = teng.eval_superstep(tparams, teval, draws)
    _assert_u8_close(teval.stack.frames, np.asarray(jeval.stack.frames),
                     "eval stack")
    assert int(teval.env_frames) == int(jeval.env_frames)
    np.testing.assert_array_equal(teval.episode_return.numpy(),
                                  np.asarray(jeval.episode_return))
    assert float(teval.completed_count) == float(jeval.completed_count)


def test_engine_draws_taus_only_for_an_agent_that_takes_them():
  _, ieng = _engines()
  d = ieng.draw(torch.Generator().manual_seed(0))
  assert tuple(d.act_taus.shape) == (4, 8)
  assert float(d.act_taus.min()) >= 0.0 and float(d.act_taus.max()) < 1.0
  e = ieng.draw(torch.Generator().manual_seed(0), ieng._eval_env(2),
                learn=False)
  assert tuple(e.act_taus.shape) == (2, 8) and e.sample_u is None
  # dqn draws no taus, so its stream of draws is what it was without them.
  deng = ttrain.build_engine("dqn", "pong", num_envs=4, replay_capacity=64,
                             device="cpu")
  d = deng.draw(torch.Generator().manual_seed(0))
  assert d.act_taus is None
  gen = torch.Generator().manual_seed(0)
  torch.testing.assert_close(d.explore_u, torch.rand((4,), generator=gen))
  torch.randint(0, 6, (4,), generator=gen)
  torch.testing.assert_close(
      d.sample_u, torch.rand(tuple(d.sample_u.shape), generator=gen))


# --- the CLI ---------------------------------------------------------------------


def _cli(tmp_path, *flags):
  ttrain.main(["--agent=iqn", "--device=cpu", "--num_envs=2",
               "--num_iterations=1", "--num_train_frames=64",
               "--num_eval_frames=32", "--max_frames_per_episode=16",
               f"--results_csv_path={tmp_path / 'r.csv'}", *flags])


def test_cli_iqn_acts_and_evaluates_below_its_min_fill(tmp_path):
  _cli(tmp_path, "--replay_capacity=4000")  # min fill 80 rows, 16 inserted
  rows = (tmp_path / "r.csv").read_text().strip().splitlines()
  assert len(rows) == 3  # header, iteration 0 (eval only), iteration 1


def test_cli_iqn_raises_at_its_first_learn_step(tmp_path):
  with pytest.raises(NotImplementedError, match="K4b"):
    _cli(tmp_path, "--replay_capacity=64")
