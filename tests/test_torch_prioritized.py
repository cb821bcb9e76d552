"""Differential tests of the double-DQN network, the double_q and prioritized
losses and prioritized/catch supersteps against the JAX package, and the
per-agent runners (CPU).

The JAX engine carries only the value tree through its learn scan and drops
`max_seen_priority` (dqn_zoo_tpu/engine/superstep.py:298-304), so its new
rows always enter at 1^α; the port raises it as dqn_zoo's agent does. The
superstep test against JAX's engine therefore loads JAX's value tree and
max-seen priority into the port before each superstep and compares what one
superstep makes of them; a second test holds the port's engine over several
supersteps to JAX's `replay_insert` and `replay_update_priorities` chained
by hand, which carry the max from one superstep into the next."""

import csv
import dataclasses
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_catch import jax_catch_env_draws
from test_torch_replay import _jax_sample_uniforms
from test_torch_slice import _assert_u8_close

from dqn_zoo_tpu.agents import get_agent as jget_agent
from dqn_zoo_tpu.agents.base import make_optimizer as jmake_optimizer
from dqn_zoo_tpu.engine import Engine as JEngine
from dqn_zoo_tpu.engine import EngineConfig as JEngineConfig
from dqn_zoo_tpu.replay import device_replay as jdr
from dqn_zoo_tpu.replay.device_replay import TransitionBatch as JBatch
from dqn_zoo_torch import convert
from dqn_zoo_torch.agents import get_agent, make_optimizer
from dqn_zoo_torch.engine import Engine, EngineConfig, SuperstepDraws
from dqn_zoo_torch.engine.superstep import leaves
from dqn_zoo_torch.replay import device_replay as tdr
from dqn_zoo_torch.replay.device_replay import TransitionBatch
from dqn_zoo_torch.run.agents import run_agent
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _jax_params(name, seed, num_actions=6):
  spec = jget_agent(name)
  net = spec.make_network(spec, num_actions)
  return jax.device_get(net.init(jax.random.PRNGKey(seed),
                                 jnp.zeros((1, 84, 84, 4), jnp.uint8)))


@pytest.mark.parametrize("name", ["double_q", "prioritized"])
def test_spec_has_the_jax_values(name):
  jspec, tspec = jget_agent(name), get_agent(name)
  for f in dataclasses.fields(tspec):
    if f.name not in ("make_network", "loss", "act", "act_takes_taus",
                      "loss_takes_taus", "act_takes_noise",
                      "loss_takes_noise"):
      assert getattr(tspec, f.name) == getattr(jspec, f.name), f.name


@pytest.mark.parametrize("name", ["double_q", "prioritized"])
def test_double_q_forward_loss_and_step_match_jax(name):
  """The shared-bias network's Q-values, the double-Q loss under IS weights,
  its gradients, the new priorities |td| and one optimizer step, from
  weights carried across by convert. Tolerances as the dqn step's
  (test_torch_ops.py): f32 convolutions summed in another order."""
  jspec = jget_agent(name)
  jnet = jspec.make_network(jspec, 6)
  online, target = _jax_params(name, 0), _jax_params(name, 1)
  assert online["head"]["out"]["b"].shape == (1,)
  rng = np.random.RandomState(6)
  b = 8
  batch = JBatch(
      s_tm1=rng.randint(0, 256, (b, 84, 84, 4)).astype(np.uint8),
      a_tm1=rng.randint(0, 6, b).astype(np.int32),
      r_t=rng.choice([-1.0, 0.0, 1.0], b).astype(np.float32),
      discount_t=(0.99 * rng.randint(0, 2, b)).astype(np.float32),
      s_t=rng.randint(0, 256, (b, 84, 84, 4)).astype(np.uint8))
  weights = rng.uniform(0.2, 1.0, b).astype(np.float32)

  def loss_fn(p):
    out = jspec.loss(jspec, jnet, p, target, batch, weights,
                     jax.random.PRNGKey(0))
    return out.loss, out.priorities

  (jloss, jprio), jgrads = jax.jit(
      jax.value_and_grad(loss_fn, has_aux=True))(online)
  jopt = jmake_optimizer(jspec)
  updates, _ = jopt.update(jgrads, jopt.init(online))
  jnew = optax.apply_updates(online, updates)
  jq = jnet.apply(online, None, batch.s_tm1).q_values

  tspec = get_agent(name)
  tnet = tspec.make_network(tspec, 6)
  tonline = convert.params_from_jax(online, "cpu", requires_grad=True)
  ttarget = convert.params_from_jax(target, "cpu")
  assert tuple(tonline["head"]["out"]["b"].shape) == (1,)
  tbatch = TransitionBatch(*(torch.from_numpy(np.asarray(x)) for x in batch))
  with torch.no_grad():
    tq = tnet.apply(tonline, tbatch.s_tm1).q_values
  np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=1e-5,
                             atol=1e-6)
  out = tspec.loss(tspec, tnet, tonline, ttarget, tbatch,
                   torch.from_numpy(weights))
  np.testing.assert_allclose(float(out.loss.detach()), float(jloss),
                             rtol=1e-5)
  np.testing.assert_allclose(out.priorities.numpy(), np.asarray(jprio),
                             rtol=1e-5, atol=1e-6)
  grads = torch.autograd.grad(out.loss, leaves(tonline))
  for a, g in zip(grads, jax.tree.leaves(jgrads)):
    np.testing.assert_allclose(a.numpy(), np.asarray(g), rtol=1e-3,
                               atol=1e-7)
  topt = make_optimizer(tspec)
  topt.step(leaves(tonline), list(grads), topt.init(leaves(tonline)))
  for a, p in zip(leaves(tonline), jax.tree.leaves(jnew)):
    np.testing.assert_allclose(a.detach().numpy(), np.asarray(p), rtol=0,
                               atol=1e-6)


# --- prioritized/catch supersteps ------------------------------------------------


def _per_engines():
  overrides = dict(target_network_update_period=400)
  jspec = dataclasses.replace(jget_agent("prioritized"), **overrides)
  tspec = dataclasses.replace(get_agent("prioritized"), **overrides)
  # Parity mode as build_engine sets it up for 4 streams, cut to batch 8:
  # two SGD steps per superstep.
  common = dict(game="catch", num_envs=4, slots_per_stream=24, batch_size=8,
                learn_every=1, updates_per_learn=2, total_train_frames=4_000)
  return (JEngine(JEngineConfig(agent=jspec, **common)),
          Engine(EngineConfig(agent=tspec, **common), device="cpu"))


def jax_per_draws(jeng, jstate) -> SuperstepDraws:
  """The draws JAX's Engine.superstep makes from jstate.rng, with the
  replay's three streams (u, p, mix) per SGD step."""
  cfg = jeng.config
  _, act_key, learn_key = jax.random.split(jstate.rng, 3)
  _, policy_key = jax.random.split(act_key)
  explore_key, uniform_key = jax.random.split(policy_key)
  b = cfg.num_envs
  t = lambda x: torch.from_numpy(np.array(x))
  sample_u = np.stack([
      _jax_sample_uniforms(jax.random.split(k)[0], cfg.batch_size)
      for k in jax.random.split(learn_key, cfg.updates_per_learn)])
  return SuperstepDraws(
      t(jax.random.uniform(explore_key, (b,))),
      t(jax.random.randint(uniform_key, (b,), 0, jeng.game.num_actions)),
      t(sample_u), jax_catch_env_draws(jstate.env))


def test_prioritized_catch_supersteps_match_jax():
  """Bounds: replay rows, the indicator tree, the game state and the frame
  count exact; frames within K2's ±1; the value tree exact at rows no
  update touched, written ones as priorities within 1e-5; loss rtol 1e-3
  and atol 2e-8; parameters as in test_whole_slice_supersteps_match_jax."""
  jeng, teng = _per_engines()
  jstate = jeng.init(jax.random.PRNGKey(2))
  tstate = convert.engine_state_from_jax(teng, jax.device_get(jstate))
  jstep = jax.jit(jeng.superstep)
  learned, moved, updated = 0, 0, 0
  for step in range(10):
    jprev = jax.device_get(jstate)
    draws = jax_per_draws(jeng, jprev)
    prev = convert.replay_from_jax(jprev.replay, 84, "cpu", prioritized=True)
    before = [x.clone() for x in prev.value_tree]
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
    for a, b in zip(tstate.replay.indicator_tree, ref.replay.indicator_tree):
      assert torch.equal(a, b), step
    for name, a, w in zip(ref.env.game_state._fields, tstate.env.game_state,
                          ref.env.game_state):
      assert torch.equal(a, w), (name, step)
    assert tstate.env_frames == ref.env_frames

    # Leaves no write of this superstep changed, on either side, agree
    # exactly; written ones are compared as priorities, |td| =
    # leaf^(1/α), within 1e-5 (Q-values of f32 convolutions summed in
    # another order, fed a few ±1 pixels); each node above them is the sum
    # of its children, rtol 1e-6.
    got, want = tstate.replay.value_tree[0], ref.replay.value_tree[0]
    untouched = (got == before[0]) & (want == before[0])
    assert torch.equal(got[untouched], want[untouched]), step
    inv = 1.0 / teng.spec.priority_exponent
    np.testing.assert_allclose(got.pow(inv).numpy(), want.pow(inv).numpy(),
                               rtol=0, atol=1e-5, err_msg=str(step))
    for lo, hi in zip(tstate.replay.value_tree, tstate.replay.value_tree[1:]):
      np.testing.assert_allclose(hi.numpy(),
                                 lo.view(-1, 128).sum(-1).numpy(), rtol=1e-6)
    updated += int((got != before[0]).sum())
    # Every priority written is at most the max seen, which the port keeps
    # as dqn_zoo does (JAX's stays at 1).
    assert float(got.pow(inv).max()) <= \
        float(tstate.replay.max_seen_priority) * (1 + 1e-6), step

    assert tstate.telemetry.learn_steps == ref.telemetry.learn_steps
    if ref.telemetry.learn_steps:
      # The loss is ~1e-6 here (catch's rewards are rare): its error is the
      # Q-values' (1e-5, as above) times |td| (~2e-3).
      np.testing.assert_allclose(float(tstate.telemetry.last_loss),
                                 float(ref.telemetry.last_loss), rtol=1e-3,
                                 atol=2e-8)
    for tree, ref_tree in ((tstate.online_params, ref.online_params),
                           (tstate.target_params, ref.target_params)):
      diff = torch.cat([(a - w).detach().abs().flatten() for a, w in
                        zip(leaves(tree), leaves(ref_tree))])
      assert float(diff.max()) <= 5e-5, (step, float(diff.max()))
      assert float((diff <= 2e-6).float().mean()) >= 0.999, step
    moved += ref.telemetry.learn_steps > learned
    learned = ref.telemetry.learn_steps
  assert learned >= 5 and moved >= 3 and updated > 0
  assert bool(ref.replay.is_terminal.any())  # catch episodes ended


def test_prioritized_engine_carries_max_seen_into_later_inserts(monkeypatch):
  """24 supersteps of the port's prioritized/catch engine (parity mode,
  2 SGD steps a learning superstep) against JAX's `replay_insert` and
  `replay_update_priorities` chained by hand on the rows the port inserted
  and the leaves and priorities its learn steps wrote, in the same order.
  Both start from max-seen priority 1e-6 (catch's |td| stay below the
  initial 1 for many supersteps), so the learn steps raise it here.
  Bounds: the max-seen priority and the indicator tree exact after every
  superstep; each leaf activated in a superstep and not rewritten by its
  learn steps is exactly the max seen before that superstep raised to α,
  on both sides; every value leaf within rtol 1e-6 (torch and XLA round
  x^0.6 up to 6 ulp apart)."""
  jeng, teng = _per_engines()
  jins = jax.jit(functools.partial(jdr.replay_insert, jeng.rcfg))
  jupd = jax.jit(functools.partial(jdr.replay_update_priorities, jeng.rcfg))
  alpha = teng.rcfg.priority_exponent
  start = np.float32(1e-6)
  tstate = teng.init(3)
  tstate.replay.max_seen_priority.fill_(float(start))
  jrep = jdr.replay_init(jeng.rcfg)._replace(max_seen_priority=jnp.float32(start))

  calls = []
  insert, update = tdr.replay_insert, tdr.replay_update_priorities

  def record_insert(cfg, state, *rows):
    calls.append(("insert", [np.array(x) for x in rows]))
    return insert(cfg, state, *rows)

  def record_update(cfg, state, sampled, priorities):
    calls.append(("update", [np.array(sampled),
                             np.array(priorities.detach())]))
    return update(cfg, state, sampled, priorities)

  monkeypatch.setattr(tdr, "replay_insert", record_insert)
  monkeypatch.setattr(tdr, "replay_update_priorities", record_update)

  raised_maxes = set()
  for step in range(24):
    m0 = tstate.replay.max_seen_priority.clone()
    ind0 = tstate.replay.indicator_tree[0].clone()
    calls.clear()
    tstate = teng.superstep(tstate, teng.draw(tstate.generator))
    written = []
    for kind, args in calls:
      if kind == "insert":
        frame, count, action, reward, discount, term = args
        jrep = jins(jrep, frame, count.astype(np.int32),
                    action.astype(np.int32), reward, discount, term)
      else:
        jrep = jupd(jrep, *args)
        written.append(args[0])

    got = tstate.replay
    assert np.float32(got.max_seen_priority.item()) == \
        np.float32(jrep.max_seen_priority), step
    np.testing.assert_array_equal(got.indicator_tree[0].numpy(),
                                  np.asarray(jrep.indicator_tree[0]))
    tleaf = got.value_tree[0].numpy()
    jleaf = np.asarray(jrep.value_tree[0])
    np.testing.assert_allclose(tleaf, jleaf, rtol=1e-6, atol=0,
                               err_msg=str(step))
    new = (ind0 == 0) & (got.indicator_tree[0] == 1)
    if written:
      new[torch.from_numpy(np.concatenate(written))] = False
    new = new.numpy()
    if new.any():
      assert (tleaf[new] == tdr._pexp(m0, alpha).item()).all(), step
      assert (jleaf[new] == np.asarray(
          jdr._pexp(jnp.float32(m0.item()), alpha))).all(), step
      if m0.item() > start:
        raised_maxes.add(m0.item())
  # Inserts took at least two different maxes, each raised by learn steps.
  assert len(raised_maxes) >= 2, raised_maxes


# --- the runners -------------------------------------------------------------------


@pytest.mark.parametrize("agent", ["prioritized", "double_q"])
def test_agent_runner_trains_on_cpu(agent, tmp_path):
  path = tmp_path / "r.csv"
  run_agent(agent, ["--device=cpu", "--environment_name=catch",
                    "--num_envs=2", "--replay_capacity=64",
                    "--min_replay_capacity_fraction=0.1", "--batch_size=8",
                    "--num_iterations=1", "--num_train_frames=64",
                    "--num_eval_frames=32", "--max_frames_per_episode=16",
                    f"--results_csv_path={path}"])
  rows = list(csv.DictReader(open(path)))
  assert [int(r["iteration"]) for r in rows] == [0, 1]
  assert float(rows[1]["train_num_episodes"]) > 0  # 16-frame episodes
  assert rows[1]["train_state_value"] != "nan"
  assert float(rows[1]["train_exploration_epsilon"]) == pytest.approx(0.01)


def test_runner_module_runs_as_a_program(tmp_path):
  """`python -m dqn_zoo_torch.run.agents.iqn` at tiny sizes on the CPU."""
  agent = "iqn"
  repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
  path = tmp_path / "r.csv"
  out = subprocess.run(
      [sys.executable, "-m", f"dqn_zoo_torch.run.agents.{agent}",
       "--device=cpu", "--num_envs=2", "--replay_capacity=64",
       "--batch_size=4", "--num_iterations=1", "--num_train_frames=64",
       "--num_eval_frames=32", "--max_frames_per_episode=16",
       f"--results_csv_path={path}"],
      cwd=repo, env=dict(os.environ, PYTHONPATH=repo), capture_output=True,
      text=True, timeout=300)
  assert out.returncode == 0, out.stderr[-2000:]
  assert "iteration:   1" in out.stderr
  assert [int(r["iteration"]) for r in csv.DictReader(open(path))] == [0, 1]
