"""Differential tests of the port's replay against the JAX package: the
fanout tree, and replay_insert/replay_sample at the TransitionBatch level
across ring wraps, exact (CPU)."""

import functools

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
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


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


# --- prioritized replay ---------------------------------------------------------

# Priorities whose square roots are dyadic: with α = 0.5 every leaf is a
# multiple of 0.5 up to 2.5, so every tree sum is exact in f32 in any order,
# and the leaves, sums and sampled leaves must agree exactly.
_DYADIC_SQUARES = np.array([0.0, 0.25, 1.0, 2.25, 4.0, 6.25], np.float32)


def _jax_sample_uniforms(sample_key, batch):
  """The u, p and mix streams replay_sample draws from its key."""
  keys = jax.random.split(sample_key, 3)
  return np.stack([np.asarray(jax.random.uniform(k, (batch,)))
                   for k in keys])


@pytest.mark.parametrize("n_step", [1, 3])
@pytest.mark.parametrize("chunk", [32, 0], ids=["chunk32", "one_max"])
def test_prioritized_insert_sample_update_match_jax(chunk, n_step):
  """PER insert at max-seen priority^α (with n-step 3's suffix flush),
  mixture sampling, IS weights (batch 64, per chunk of 32 and over the
  batch) and priority updates with repeated leaves, against the JAX
  package. Tolerances: leaves, tree sums,
  sampled leaves and batches exact; IS weights rtol 1e-6."""
  s, c, batch, beta = 6, 24, 64, 0.7  # 144 leaves: a two-level tree
  common = dict(num_streams=s, slots_per_stream=c, n_step=n_step,
                priority_exponent=0.5,
                uniform_sample_probability=0.25,
                normalize_weights_chunk=chunk)
  jcfg = jdr.ReplayConfig(**common)
  tcfg = tdr.ReplayConfig(**common)
  jstate = jdr.replay_init(jcfg)
  tstate = tdr.replay_init(tcfg, "cpu")
  assert tstate.value_tree is not tstate.indicator_tree
  jinsert = jax.jit(functools.partial(jdr.replay_insert, jcfg))
  jsample = jax.jit(functools.partial(jdr.replay_sample, jcfg,
                                      batch_size=batch))
  jupdate = jax.jit(functools.partial(jdr.replay_update_priorities, jcfg))
  rng = np.random.RandomState(7 + n_step)
  key = jax.random.PRNGKey(7 + n_step)
  count = np.zeros(s, np.int32)
  sampled = repeats = 0
  for step in range(c + 6):  # past one wrap of the ring
    terminal = rng.uniform(size=s) < 0.1
    count = np.where(count >= 4, 4, count + 1).astype(np.int32)
    row = dict(
        frame=rng.randint(0, 256, (s, 84, 84)).astype(np.uint8),
        stack_count=count.copy(),
        action=rng.randint(0, 6, s).astype(np.int32),
        reward=rng.choice([-1.0, 0.0, 1.0], s).astype(np.float32),
        discount=(0.99 * ~terminal).astype(np.float32),
        is_terminal=terminal)
    count = np.where(terminal, 0, count)
    jstate = jinsert(jstate, **{k: jnp.asarray(v) for k, v in row.items()})
    tstate = tdr.replay_insert(tcfg, tstate,
                               **{k: torch.from_numpy(v)
                                  for k, v in row.items()})
    if int(tdr.replay_size(tstate)) < 8:
      continue
    key, sample_key = jax.random.split(key)
    jbatch, jleaves, jweights = jsample(
        jstate, sample_key, importance_sampling_exponent=beta)
    u = _jax_sample_uniforms(sample_key, batch)
    tbatch, tleaves, tweights = tdr.replay_sample(
        tcfg, tstate, torch.from_numpy(u), beta)
    np.testing.assert_array_equal(tleaves.numpy(), np.asarray(jleaves))
    for name, a, b in zip(jbatch._fields, tbatch, jbatch):
      np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    np.testing.assert_allclose(tweights.numpy(), np.asarray(jweights),
                               rtol=1e-6, atol=0)
    w = tweights.numpy().reshape(-1, chunk or batch)
    assert (w.max(axis=1) == 1.0).all() and (w > 0).all()
    # New priorities, one per sample: a leaf drawn twice gets two different
    # ones, and the last must win.
    prio = rng.choice(_DYADIC_SQUARES, batch)
    repeats += batch - len(np.unique(np.asarray(jleaves)))
    jstate = jupdate(jstate, jleaves, jnp.asarray(prio))
    tdr.replay_update_priorities(tcfg, tstate, tleaves,
                                 torch.from_numpy(prio))
    ref = convert.replay_from_jax(jax.device_get(jstate), 84, "cpu",
                                  prioritized=True)
    for a, b in zip(tstate.value_tree + tstate.indicator_tree,
                    ref.value_tree + ref.indicator_tree):
      assert torch.equal(a, b), step
    assert torch.equal(tstate.max_seen_priority, ref.max_seen_priority)
    sampled += 1
  assert sampled > c // 2 and repeats > 50
  assert float(tstate.max_seen_priority) == 6.25  # new rows enter at 2.5


def test_uniform_replay_keeps_one_tree():
  cfg = tdr.ReplayConfig(num_streams=2, slots_per_stream=16)
  state = tdr.replay_init(cfg, "cpu")
  assert state.value_tree is state.indicator_tree


@pytest.mark.parametrize("pattern", ["repeats", "all_same"])
def test_fanout_set_duplicates_last_write_wins(pattern):
  """A scatter keeps an arbitrary one of duplicate writes; fanout_set keeps
  the last, as the JAX package promises. Exact."""
  rng = np.random.RandomState(3)
  cap = 300
  if pattern == "repeats":
    idx = rng.randint(0, 20, 200).astype(np.int32)  # ~10 writes per leaf
  else:
    idx = np.full(64, 17, np.int32)
  val = rng.uniform(0, 4, idx.shape[0]).astype(np.float32)
  jt = jft.fanout_set(jft.fanout_init(cap), jnp.asarray(idx),
                      jnp.asarray(val))
  tt = tft.fanout_init(cap, "cpu")
  tft.fanout_set(tt, torch.from_numpy(idx).long(), torch.from_numpy(val))
  last = {i: v for i, v in zip(idx.tolist(), val.tolist())}
  for i, v in last.items():
    assert float(tt[0][i]) == v
  for a, b in zip(tt, jt):
    np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_importance_sampling_weights_match_jax():
  """Standalone IS weights, rtol 1e-6."""
  rng = np.random.RandomState(4)
  probs = rng.uniform(1e-4, 1e-2, 64).astype(np.float32)
  for normalize in (True, False):
    want = jdr.importance_sampling_weights(jnp.asarray(probs), 512.0, 0.55,
                                           normalize)
    got = tdr.importance_sampling_weights(torch.from_numpy(probs), 512.0,
                                          0.55, normalize)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
