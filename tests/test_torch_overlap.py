"""Overlap mode (`EngineConfig.overlap_env_learn`) of the port's fused
engine (CPU): dqn/pong supersteps against the JAX engine in the same mode,
from one JAX state and with the draws JAX takes from its key chain; the
learn gate opening one superstep later than without overlap; and, with
prioritized replay, the deferred insert landing after the learn block's
priority write.
"""

import dataclasses

import jax
import numpy as np
import torch

from test_torch_slice import _assert_u8_close, _engines, jax_draws

from dqn_zoo_torch import convert
from dqn_zoo_torch.engine import Engine
from dqn_zoo_torch.engine.superstep import leaves
from dqn_zoo_torch.replay import device_replay as dr
from dqn_zoo_torch.replay import fanout_tree as ft
from dqn_zoo_torch.run.train import build_engine
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _first_learning_superstep(learn_steps):
  return next(i for i, n in enumerate(learn_steps) if n > 0)


def test_overlap_supersteps_match_jax_and_learning_starts_one_later():
  jeng, teng = _engines(overlap_env_learn=True)
  assert jeng.config.overlap_env_learn and teng.config.overlap_env_learn
  jstate = jax.jit(jeng.init)(jax.random.PRNGKey(0))
  init = jax.device_get(jstate)
  tstate = convert.engine_state_from_jax(teng, init)
  jstep = jax.jit(jeng.superstep)
  all_draws, learn_steps, swaps = [], [], 0
  for step in range(16):
    draws = jax_draws(jeng, jax.device_get(jstate))
    all_draws.append(draws)
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
    assert tstate.replay.t == ref.replay.t == step + 1
    assert tstate.env_frames == ref.env_frames
    assert tstate.telemetry.learn_steps == ref.telemetry.learn_steps
    if ref.telemetry.learn_steps:
      np.testing.assert_allclose(float(tstate.telemetry.last_loss),
                                 float(ref.telemetry.last_loss), rtol=1e-3)
    # test_torch_slice's tolerances: the ±1 observation pixels feed the nets.
    for tree, ref_tree in ((tstate.online_params, ref.online_params),
                           (tstate.target_params, ref.target_params)):
      diff = torch.cat([(a - w).detach().abs().flatten() for a, w in
                        zip(leaves(tree), leaves(ref_tree))])
      assert float(diff.max()) <= 5e-5, (step, float(diff.max()))
      assert float((diff <= 2e-6).float().mean()) >= 0.999, step
    learn_steps.append(ref.telemetry.learn_steps)
    swaps += any(not torch.equal(a, b) for a, b in
                 zip(prev_target, leaves(tstate.target_params)))
  assert learn_steps[-1] >= 5 and swaps >= 1

  # Without overlap, from the same state and draws: the gate reads the
  # replay after the insert, so learning starts one superstep earlier.
  _, plain = _engines()
  pstate = convert.engine_state_from_jax(plain, init)
  plain_steps = []
  for draws in all_draws[:_first_learning_superstep(learn_steps) + 1]:
    pstate = plain.superstep(pstate, draws)
    plain_steps.append(pstate.telemetry.learn_steps)
  assert _first_learning_superstep(plain_steps) == \
      _first_learning_superstep(learn_steps) - 1


def test_overlap_insert_lands_after_the_priority_write():
  """The deferred insert activates its rows at the max-seen priority that
  the learn block of the same superstep raised, and its kills of reused
  slots come after that block's priority writes."""
  base = build_engine("prioritized", "pong", num_envs=4, replay_capacity=64,
                      batch_size=32, min_replay_capacity_fraction=0.1,
                      max_frames_per_episode=48, device="cpu")
  eng = Engine(dataclasses.replace(base.config, overlap_env_learn=True),
               device="cpu")
  rcfg, c = eng.rcfg, eng.config.slots_per_stream
  assert rcfg.priority_exponent > 0
  state = eng.init(0)
  # Past a wrap of the 16 slots, so the insert reuses slots of active rows.
  state = eng.run(state, c + 2)
  assert state.telemetry.learn_steps > 0
  for _ in range(3):
    state.replay.max_seen_priority.fill_(1e-3)
    t = state.replay.t
    streams = torch.arange(rcfg.num_streams)
    leaf = lambda step: streams * c + step % c
    # Row t - n activates at this insert unless it is terminal or was
    # activated early (a terminal insert flushes the rows before it).
    new = leaf(t - rcfg.n_step)
    was_active = ft.fanout_get(state.replay.indicator_tree, new) > 0
    steps = state.telemetry.learn_steps
    state = eng.superstep(state)
    assert state.telemetry.learn_steps == steps + eng.config.updates_per_learn
    top = state.replay.max_seen_priority
    assert float(top) > 1e-3  # the learn block raised it
    active = (ft.fanout_get(state.replay.indicator_tree, new) > 0) & \
        ~was_active
    assert bool(active.any())
    values = ft.fanout_get(state.replay.value_tree, new)[active]
    torch.testing.assert_close(values, dr._pexp(top, rcfg.priority_exponent)
                               .expand_as(values), rtol=0, atol=0)
    # The slots this insert reuses hold nothing, whatever learn wrote.
    for off in range(4):
      killed = leaf(t + off)
      assert not bool(ft.fanout_get(state.replay.value_tree, killed).any())
      assert not bool(ft.fanout_get(state.replay.indicator_tree,
                                    killed).any())
