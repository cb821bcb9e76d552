"""Differential tests of the port's replay against the JAX package: the
fanout tree, and replay_insert/replay_sample at the TransitionBatch level
across ring wraps, exact (CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dqn_zoo_tpu.replay import device_replay as jdr
from dqn_zoo_tpu.replay import fanout_tree as jft
from dqn_zoo_torch import convert
from dqn_zoo_torch.replay import device_replay as tdr
from dqn_zoo_torch.replay import fanout_tree as tft


def test_fanout_tree_set_query_match_jax():
  rng = np.random.RandomState(0)
  cap = 300  # two levels of radix 128
  jt = jft.fanout_init(cap)
  tt = tft.fanout_init(cap, "cpu")
  assert [x.shape[0] for x in tt] == [x.shape[0] for x in jt]
  for _ in range(3):
    idx = rng.choice(cap, 40, replace=False).astype(np.int32)
    val = rng.randint(0, 2, 40).astype(np.float32)
    jt = jft.fanout_set(jt, jnp.asarray(idx), jnp.asarray(val))
    tft.fanout_set(tt, torch.from_numpy(idx).long(), torch.from_numpy(val))
  for a, b in zip(tt, jt):
    np.testing.assert_array_equal(a.numpy(), np.asarray(b))
  total = float(tft.fanout_total(tt))
  assert total == float(jft.fanout_total(jt))
  targets = (rng.uniform(0, 1, 64) * total).astype(np.float32)
  np.testing.assert_array_equal(
      tft.fanout_query(tt, torch.from_numpy(targets)).numpy(),
      np.asarray(jft.fanout_query(jt, jnp.asarray(targets))))


@pytest.mark.parametrize("n_step", [1, 3])
def test_insert_and_sample_match_jax_across_wraps(n_step):
  s, c, batch = 3, 9, 16
  jcfg = jdr.ReplayConfig(num_streams=s, slots_per_stream=c, n_step=n_step)
  tcfg = tdr.ReplayConfig(num_streams=s, slots_per_stream=c, n_step=n_step)
  jstate = jdr.replay_init(jcfg)
  tstate = tdr.replay_init(tcfg, "cpu")
  rng = np.random.RandomState(n_step)
  key = jax.random.PRNGKey(n_step)
  count = np.zeros(s, np.int32)
  samples = 0
  for step in range(4 * c):  # several wraps of the ring
    terminal = rng.uniform(size=s) < 0.15
    count = np.where(count >= 4, 4, count + 1).astype(np.int32)
    row = dict(
        frame=rng.randint(0, 256, (s, 84, 84)).astype(np.uint8),
        stack_count=count.copy(),
        action=rng.randint(0, 6, s).astype(np.int32),
        reward=rng.choice([-1.0, 0.0, 1.0], s).astype(np.float32),
        discount=(0.99 * ~terminal).astype(np.float32),
        is_terminal=terminal)
    count = np.where(terminal, 0, count)
    jstate = jdr.replay_insert(jcfg, jstate,
                               **{k: jnp.asarray(v) for k, v in row.items()})
    tstate = tdr.replay_insert(tcfg, tstate,
                               **{k: torch.from_numpy(v)
                                  for k, v in row.items()})
    # Rows, activations and the unpadded frame store match exactly.
    ref = convert.replay_from_jax(jax.device_get(jstate), 84, "cpu")
    for f in ("frames", "stack_count", "action", "reward", "discount",
              "is_terminal", "row_t"):
      assert torch.equal(getattr(tstate, f), getattr(ref, f)), (step, f)
    assert tstate.t == ref.t
    assert torch.equal(tstate.indicator_tree[0], ref.indicator_tree[0])
    if int(tdr.replay_size(tstate)) == 0:
      continue
    key, sample_key = jax.random.split(key)
    jbatch, _, _ = jdr.replay_sample(jcfg, jstate, sample_key, batch)
    # The uniform draw replay_sample makes from its key.
    u_key = jax.random.split(sample_key, 3)[0]
    u = np.asarray(jax.random.uniform(u_key, (batch,)))
    tbatch, _, weights = tdr.replay_sample(tcfg, tstate,
                                             torch.from_numpy(u.copy()))
    for name, a, b in zip(jbatch._fields, tbatch, jbatch):
      np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    assert torch.equal(weights, torch.ones(batch))
    samples += 1
  assert samples > 2 * c


def test_prioritized_replay_not_ported_yet():
  with pytest.raises(NotImplementedError):
    tdr.ReplayConfig(num_streams=2, slots_per_stream=16,
                     priority_exponent=0.5)
