"""Differential tests of the port's host replay (dqn_zoo_torch/replay/
host.py) and device sum tree (replay/sum_tree.py) against the JAX
package's on the CPU.

The host replay is NumPy on both sides: from one RandomState seed and one
scripted sequence of adds, samples, priority updates and evictions, the
sampled ids, transitions and importance weights must be equal bit for bit.
"""

import copy

import dm_env
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dqn_zoo_tpu.replay import host as jhost
from dqn_zoo_tpu.replay import sum_tree as jst
from dqn_zoo_torch.envs import timestep as ts_lib
from dqn_zoo_torch.replay import host
from dqn_zoo_torch.replay import sum_tree as st
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

STRUCTURE = dict(s_tm1=None, a_tm1=None, r_t=None, discount_t=None, s_t=None)


def _transition(cls, rng):
  return cls(s_tm1=rng.randint(0, 256, (4, 3)).astype(np.uint8),
             a_tm1=int(rng.randint(6)), r_t=float(rng.randn()),
             discount_t=float(rng.rand()),
             s_t=rng.randint(0, 256, (4, 3)).astype(np.uint8))


def _assert_same(a, b, what):
  for f in host.Transition._fields:
    x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
    assert x.dtype == y.dtype and np.array_equal(x, y), (what, f)


def _is_exponent(t):
  """A plain-number IS schedule, so both packages take the same f64 pow."""
  return min(1.0, 0.4 + 0.01 * t)


def _replays(prioritized, capacity, usp=0.0, compress=False, seed=0):
  out = []
  for lib in (jhost, host):
    kw = dict(capacity=capacity, structure=lib.Transition(**STRUCTURE),
              random_state=np.random.RandomState(seed))
    if compress:
      kw["encoder"] = lambda tr, lib=lib: tr._replace(
          s_tm1=lib.compress_array(tr.s_tm1), s_t=lib.compress_array(tr.s_t))
      kw["decoder"] = lambda tr, lib=lib: tr._replace(
          s_tm1=lib.uncompress_array(tr.s_tm1),
          s_t=lib.uncompress_array(tr.s_t))
    if prioritized:
      out.append(lib.PrioritizedTransitionReplay(
          priority_exponent=0.6, importance_sampling_exponent=_is_exponent,
          uniform_sample_probability=usp, normalize_weights=True, **kw))
    else:
      out.append(lib.TransitionReplay(**kw))
  return out


def test_uniform_replay_samples_match_jax_bit_for_bit():
  jr, tr = _replays(False, capacity=24)
  rng = np.random.RandomState(1)
  for step in range(60):  # evicts past capacity from step 24 on
    t = _transition(jhost.Transition, rng)
    jr.add(t)
    tr.add(host.Transition(*t))
    if step % 5 == 4:
      _assert_same(jr.sample(16), tr.sample(16), step)
      assert list(jr.ids()) == list(tr.ids())
  assert tr.size == 24 and tr.check_valid()[0]


def test_prioritized_replay_samples_match_jax_bit_for_bit():
  """uniform_sample_probability 0.1, zero and non-zero priorities, priority
  updates, evictions, and the all-zero root fallback to uniform."""
  jr, tr = _replays(True, capacity=20, usp=0.1)
  rng = np.random.RandomState(2)
  for step in range(50):
    t = _transition(jhost.Transition, rng)
    p = float(rng.choice([0.0, rng.rand() * 3]))
    jr.add(t, priority=p)
    tr.add(host.Transition(*t), priority=p)
    if step % 4 == 3:
      (jt, jids, jw), (tt, tids, tw) = jr.sample(12), tr.sample(12)
      _assert_same(jt, tt, step)
      np.testing.assert_array_equal(tids, jids)
      assert tw.dtype == jw.dtype and np.array_equal(tw, jw), step
      new = rng.rand(12) * 2 * (rng.rand(12) > 0.2)
      jr.update_priorities(jids, new)
      tr.update_priorities(tids, new)
    ok, msg = tr.check_valid()
    assert ok, msg
  # Every priority zero: the root is 0, so sampling falls back to uniform.
  ids = list(tr._distribution.ids())
  jr.update_priorities(ids, np.zeros(len(ids)))
  tr.update_priorities(ids, np.zeros(len(ids)))
  assert tr._distribution._tree.root() == 0.0
  (jt, jids, jw), (tt, tids, tw) = jr.sample(12), tr.sample(12)
  _assert_same(jt, tt, "root 0")
  np.testing.assert_array_equal(tids, jids)
  np.testing.assert_array_equal(tw, jw)


def _ts(step_type, obs, reward=None, discount=None):
  return ts_lib.TimeStep(step_type, reward, discount, obs)


def _stream(rng, n):
  """Timesteps of several episodes: FIRST, MIDs, then LAST (discount 0 or
  a truncation's 1)."""
  out, t = [], 0
  while len(out) < n:
    out.append(_ts(ts_lib.StepType.FIRST, np.full((2,), t, np.uint8)))
    for k in range(rng.randint(1, 7)):
      t += 1
      out.append(_ts(ts_lib.StepType.MID, np.full((2,), t, np.uint8),
                     float(rng.randn()), float(rng.choice([0.9, 0.0]))))
    t += 1
    out.append(_ts(ts_lib.StepType.LAST, np.full((2,), t, np.uint8),
                   float(rng.randn()), float(rng.choice([0.0, 1.0]))))
  return out


@pytest.mark.parametrize("n", [1, 3])
def test_accumulators_match_jax(n):
  rng = np.random.RandomState(n)
  stream = _stream(rng, 60)
  if n == 1:
    jacc, tacc = jhost.TransitionAccumulator(), host.TransitionAccumulator()
  else:
    jacc = jhost.NStepTransitionAccumulator(n)
    tacc = host.NStepTransitionAccumulator(n)
  got, want = [], []
  for ts in stream:
    a = int(rng.randint(4))
    want += list(jacc.step(dm_env.TimeStep(*ts), a))  # dm_env's timesteps
    got += list(tacc.step(ts, a))
  assert len(got) == len(want) > len(stream) // 2
  for g, w in zip(got, want):
    _assert_same(g, w, "accumulated")
    assert type(g.r_t) is type(w.r_t)


def test_jax_replay_state_loads_and_samples_the_same():
  """A JAX prioritized replay with compressed observations, part way
  through eviction: its get_state() loads into the port's, and from the
  same RandomState state the next samples are equal."""
  from dqn_zoo_torch import convert
  jr, _ = _replays(True, capacity=16, usp=0.05, compress=True)
  rng = np.random.RandomState(3)
  for _ in range(28):
    jr.add(_transition(jhost.Transition, rng), priority=float(rng.rand()))
  state = copy.deepcopy(jr.get_state())
  rs_state = jr._distribution._random_state.get_state()
  _, tr = _replays(True, capacity=16, usp=0.05, compress=True, seed=99)
  tr.set_state(convert._replay_state_from_jax(state))
  tr._distribution._random_state.set_state(rs_state)
  assert tr.check_valid()[0]
  for _ in range(3):
    (jt, jids, jw), (tt, tids, tw) = jr.sample(8), tr.sample(8)
    _assert_same(jt, tt, "after load")
    np.testing.assert_array_equal(tids, jids)
    np.testing.assert_array_equal(tw, jw)


def test_compression_round_trip_and_jax_bytes():
  rng = np.random.RandomState(4)
  x = rng.randint(0, 256, (84, 84, 4)).astype(np.uint8)
  packed = host.compress_array(x)
  back = host.uncompress_array(packed)
  assert back.dtype == x.dtype and np.array_equal(back, x)
  assert packed[0] == jhost.compress_array(x)[0]  # zlib level 1 both
  assert np.array_equal(host.uncompress_array(jhost.compress_array(x)), x)


def test_device_sum_tree_lands_on_the_card_unless_asked_for_the_cpu():
  if torch.cuda.is_available():
    pytest.skip("checks the error raised where no card is")
  with pytest.raises(RuntimeError, match="CUDA is not available"):
    st.sum_tree_init(8)
  tree = st.sum_tree_init(8, device="cpu")
  assert tree.device == torch.device("cpu") and tree.shape == (16,)
  assert tree.dtype == torch.float32 and not bool(tree.any())


def test_device_sum_tree_matches_jax():
  """Random batched sets with duplicate indices, set_all, get, total and
  query at P = 256: leaves and query indices exact, totals within 1e-6
  relative."""
  p = 256
  rng = np.random.RandomState(5)
  jt, tt = jst.sum_tree_init(p), st.sum_tree_init(p, device="cpu")
  with pytest.raises(ValueError):
    st.sum_tree_init(24, device="cpu")

  def check():
    np.testing.assert_array_equal(st.sum_tree_leaves(tt).numpy(),
                                  np.asarray(jst.sum_tree_leaves(jt)))
    np.testing.assert_allclose(float(st.sum_tree_total(tt)),
                               float(jst.sum_tree_total(jt)), rtol=1e-6)
    targets = (rng.rand(64) * float(jst.sum_tree_total(jt))).astype(
        np.float32)
    np.testing.assert_array_equal(
        st.sum_tree_query(tt, torch.from_numpy(targets)).numpy(),
        np.asarray(jst.sum_tree_query(jt, jnp.asarray(targets))))
    idx = rng.randint(0, p, 16)
    np.testing.assert_array_equal(
        st.sum_tree_get(tt, torch.from_numpy(idx)).numpy(),
        np.asarray(jst.sum_tree_get(jt, jnp.asarray(idx))))

  leaves = (rng.rand(p) * (rng.rand(p) > 0.3)).astype(np.float32)
  jt = jst.sum_tree_set_all(jt, jnp.asarray(leaves))
  tt = st.sum_tree_set_all(tt, torch.from_numpy(leaves))
  check()
  for _ in range(4):
    idx = rng.randint(0, 24, 32)  # many duplicates: the last write wins
    vals = (rng.rand(32) * 5).astype(np.float32)
    jt = jst.sum_tree_set(jt, jnp.asarray(idx), jnp.asarray(vals))
    tt = st.sum_tree_set(tt, torch.from_numpy(idx), torch.from_numpy(vals))
    check()
  assert st.capacity_of(tt) == p
