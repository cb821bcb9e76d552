"""Differential tests of the port's host compatibility layer against the
JAX package on the CPU: processors.AtariProcessor and
AtariEnvironmentWrapper, parts (run_loop, truncation, generate_statistics,
the trackers, EpsilonGreedyActor) and envs.dm_adapter.GameEnvironment.

JAX's adapter and actor draw from keys; the port's take draws as inputs.
`JaxAdapterDraws` mirrors JaxGameEnvironment's keys and hands the port's
adapter the values JAX draws; the actor's draw hook repeats JAX's actor's
key splits.
"""

import functools
import itertools

import dm_env
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dqn_zoo_tpu import nets as jnets
from dqn_zoo_tpu import parts as jparts
from dqn_zoo_tpu import processors as jprocessors
from dqn_zoo_tpu.envs.api import get_game as jget_game
from dqn_zoo_tpu.envs.dm_adapter import JaxGameEnvironment
from dqn_zoo_torch import convert, nets, parts, processors
from dqn_zoo_torch.envs import timestep as ts_lib
from dqn_zoo_torch.envs.dm_adapter import GameEnvironment
from dqn_zoo_torch.envs.games.catch import CatchInitDraws
from dqn_zoo_torch.envs.games.pong import BOTTOM, TOP, PongInitDraws
from dqn_zoo_torch.envs.games.pong import PongStepDraws
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

split = jax.random.split


def _t1(x):
  """One JAX scalar as a (1,) tensor: the port's games are batched."""
  return torch.from_numpy(np.array(x)).reshape(1)


def _pong_init(k):
  key, k1, k2, k3 = split(k, 4)
  _, kv = split(key)
  return PongInitDraws(
      _t1(jax.random.bernoulli(k1)),
      _t1(jax.random.uniform(kv, (), minval=-2.0, maxval=2.0)),
      _t1(jax.random.uniform(k2, (), minval=float(TOP) + 20.0,
                             maxval=float(BOTTOM) - 24.0)),
      _t1(jax.random.randint(k3, (), 2, 12)))


def _pong_step(game_key):
  return PongStepDraws(_t1(jax.random.uniform(split(game_key)[1], (),
                                              minval=-2.0, maxval=2.0)))


def _catch_init(k):
  _, k1, k2 = split(k, 3)
  return CatchInitDraws(_t1(jax.random.randint(k1, (), 0, 5)),
                        _t1(jax.random.randint(k2, (), 0, 5)))


DRAWS = {"pong": (_pong_init, _pong_step),
         "catch": (_catch_init, lambda key: None)}


@functools.lru_cache(maxsize=None)
def _jitted(name):
  game = jget_game(name)
  return jax.jit(game.init), jax.jit(game.step)


class JaxAdapterDraws:
  """The draws JaxGameEnvironment(name, seed, max_noops) makes, for the
  port's GameEnvironment: it keeps a mirror of the JAX adapter's key and
  game state, stepped with the same actions."""

  def __init__(self, name, seed, max_noops):
    self._init_draws, self._step_draws = DRAWS[name]
    self._init, self._step = _jitted(name)
    self._rng = jax.random.PRNGKey(seed)
    self._max_noops = max_noops
    self._state = None

  def reset(self):
    self._rng, init_key, noop_key = split(self._rng, 3)
    self._state = self._init(init_key)
    n = int(jax.random.randint(noop_key, (), 1, self._max_noops + 1))
    return self._init_draws(init_key), n

  def step(self, action):
    d = self._step_draws(self._state.key)
    self._state = self._step(self._state, jnp.asarray(action))[0]
    return d


def _same_timestep(a, b, what):
  assert int(a.step_type) == int(b.step_type), what
  assert a.reward == b.reward and a.discount == b.discount, what
  if isinstance(a.observation, tuple):
    for x, y in zip(a.observation, b.observation):
      x, y = np.asarray(x), np.asarray(y)
      assert x.dtype == y.dtype and np.array_equal(x, y), what
  else:
    assert a.observation.dtype == b.observation.dtype, what
    assert np.array_equal(a.observation, b.observation), what


# --- the adapter --------------------------------------------------------------


@pytest.mark.parametrize("name", ["pong", "catch"])
def test_game_environment_matches_jax_adapter(name):
  """~200 raw frames with an explicit reset part way (catch also ends an
  episode and steps past LAST): (rgb, lives), rewards and step types bit
  for bit."""
  jenv = JaxGameEnvironment(name, seed=7, max_noops=5)
  tenv = GameEnvironment(name, max_noops=5, device="cpu",
                         draws=JaxAdapterDraws(name, 7, 5))
  assert tenv.action_spec().num_values == jenv.action_spec().num_values
  assert tenv.observation_spec()[0].shape == (210, 160, 3)
  rng = np.random.RandomState(0)
  _same_timestep(tenv.reset(), jenv.reset(), "reset")
  lasts = 0
  for frame in range(200):
    if frame == 120:
      _same_timestep(tenv.reset(), jenv.reset(), "explicit reset")
      continue
    a = int(rng.randint(jenv.action_spec().num_values))
    ts_t, ts_j = tenv.step(a), jenv.step(a)
    _same_timestep(ts_t, ts_j, (name, frame))
    lasts += ts_j.last()
  assert name == "pong" or lasts >= 1


def test_noop_start_that_ends_the_episode_raises():
  from dqn_zoo_torch.envs.games import catch
  game = catch.GAME._replace(step=lambda s, a, d: (
      s, torch.zeros(1), torch.ones(1, dtype=torch.bool),
      torch.zeros(1, dtype=torch.bool)))
  env = GameEnvironment(game, seed=0, max_noops=3, device="cpu")
  with pytest.raises(RuntimeError, match="noop"):
    env.reset()


# --- the processor ------------------------------------------------------------


@pytest.mark.parametrize("name,frames", [("pong", 320), ("breakout", 420)])
def test_atari_processor_matches_jax(name, frames):
  """JAX's adapter's raw timesteps into both processors: the None pattern,
  step types, rewards, discounts and observations bit for bit; breakout
  loses lives (discount 0 on MID)."""
  env = JaxGameEnvironment(name, seed=3, max_noops=30)
  jp, tp = jprocessors.atari(), processors.atari()
  rng = np.random.RandomState(1)
  ts = env.reset()
  emitted = zero_discounts = 0
  for frame in range(frames):
    a, b = jp(ts), tp(ts)
    assert (a is None) == (b is None), frame
    if a is not None:
      _same_timestep(b, a, (name, frame))
      emitted += 1
      zero_discounts += bool(a.mid() and a.discount == 0.0)
    ts = env.reset() if ts.last() else env.step(
        int(rng.randint(env.action_spec().num_values)))
  assert emitted >= frames // 4
  assert name != "breakout" or zero_discounts >= 1


def test_environment_wrapper_matches_jax():
  jw = jprocessors.AtariEnvironmentWrapper(
      JaxGameEnvironment("catch", seed=2, max_noops=3))
  tw = processors.AtariEnvironmentWrapper(
      JaxGameEnvironment("catch", seed=2, max_noops=3))
  assert tw.observation_spec().shape == jw.observation_spec().shape
  _same_timestep(tw.reset(), jw.reset(), "reset")
  rng = np.random.RandomState(2)
  for step in range(40):
    a = int(rng.randint(3))
    b, w = tw.step(a), jw.step(a)
    _same_timestep(b, w, step)


def test_processor_without_grayscale_matches_jax():
  rng = np.random.RandomState(5)
  kw = dict(grayscaling=False, num_action_repeats=1)
  jp, tp = jprocessors.atari(**kw), processors.atari(**kw)
  frame = lambda: (rng.randint(0, 256, (210, 160, 3)).astype(np.uint8),
                   np.int32(3))
  ts = dm_env.restart(frame())
  _same_timestep(tp(ts), jp(ts), "colour FIRST")
  ts = dm_env.transition(1.0, frame())
  _same_timestep(tp(ts), jp(ts), "colour MID")


# --- run_loop, statistics and trackers ----------------------------------------


def _scripted(lib, parts_lib):
  """A scripted env and agent written against `lib` (dm_env or the port's
  envs.timestep) and `parts_lib`'s Agent."""

  class Env:
    def __init__(self):
      self._rng = np.random.RandomState(0)
      self._t = 0

    def reset(self):
      self._t = 0
      return lib.restart(np.zeros((2,), np.uint8))

    def step(self, action):
      self._t += 1
      obs = np.full((2,), self._t + action, np.uint8)
      r = float(self._rng.randn())
      if self._t >= 1 + self._rng.randint(4, 12):
        return lib.termination(r, obs)
      return lib.transition(r, obs, float(self._rng.choice([1.0, 0.5])))

  class Agent(parts_lib.Agent):
    def __init__(self):
      self._n = 0

    def step(self, timestep):
      self._n += 1
      return self._n % 3

    def reset(self):
      pass

    def get_state(self):
      return {}

    def set_state(self, state):
      del state

    @property
    def statistics(self):
      return {"state_value": float(np.sin(self._n)),
              "other": float(self._n)}

  return Env(), Agent()


def test_run_loop_and_statistics_match_jax():
  """The same yields (truncation at 6 steps, the extra step on LAST, the
  yields before resets) and the same tracker statistics, step rate and
  duration aside."""
  jenv, jagent = _scripted(dm_env, jparts)
  tenv, tagent = _scripted(ts_lib, parts)
  jloop = jparts.run_loop(jagent, jenv, max_steps_per_episode=6,
                          yield_before_reset=True)
  tloop = parts.run_loop(tagent, tenv, max_steps_per_episode=6,
                         yield_before_reset=True)
  truncated = 0
  for k, (a, b) in enumerate(zip(itertools.islice(jloop, 150),
                                 itertools.islice(tloop, 150))):
    assert (a[1] is None) == (b[1] is None) and a[3] == b[3], k
    if a[1] is not None:
      _same_timestep(b[1], a[1], k)
      truncated += bool(a[1].last() and a[1].discount != 0.0)
  assert truncated >= 1

  jenv, jagent = _scripted(dm_env, jparts)
  tenv, tagent = _scripted(ts_lib, parts)
  want = jparts.generate_statistics(
      jparts.make_default_trackers(jagent), itertools.islice(
          jparts.run_loop(jagent, jenv, max_steps_per_episode=6), 300))
  got = parts.generate_statistics(
      parts.make_default_trackers(tagent), itertools.islice(
          parts.run_loop(tagent, tenv, max_steps_per_episode=6), 300))
  assert set(got) == set(want)
  for k in want:
    if k not in ("step_rate", "duration"):
      assert got[k] == want[k] or (np.isnan(got[k]) and np.isnan(want[k])), k
  assert got["num_steps"] == 300 and got["step_rate"] > 0


# --- the actor over a real dm_env environment ----------------------------------


def test_epsilon_greedy_actor_matches_jax_through_run_loop():
  """JAX's adapter (a dm_env.Environment) drives the port's run_loop,
  processor and actor, and JAX's the same on a twin env: at ε = 0.5 with
  the draws of JAX's chain, the same actions on every frame."""
  jnet = jnets.dqn_atari_network(3)
  jparams = jnet.init(jax.random.PRNGKey(0),
                      jnp.zeros((1, 84, 84, 4), jnp.uint8))
  jactor = jparts.EpsilonGreedyActor(jprocessors.atari(), jnet, 0.5,
                                     jax.random.PRNGKey(1))
  jactor.network_params = jparams
  tactor = parts.EpsilonGreedyActor(processors.atari(),
                                    nets.dqn_atari_network(3), 0.5, seed=0,
                                    device="cpu")
  tactor.network_params = convert.params_from_jax(jax.device_get(jparams),
                                                  "cpu")

  def jax_draw(num_actions):
    _, _, policy_key = split(jactor._rng_key, 3)
    explore_key, uniform_key = split(policy_key)
    return (_t1(jax.random.uniform(explore_key, (1,))),
            _t1(jax.random.randint(uniform_key, (1,), 0, num_actions)))

  tactor.draw = jax_draw
  jloop = jparts.run_loop(jactor, JaxGameEnvironment("catch", seed=4,
                                                     max_noops=3))
  tloop = parts.run_loop(tactor, JaxGameEnvironment("catch", seed=4,
                                                    max_noops=3))
  actions = []
  for k in range(200):
    b = next(tloop)  # the port's draw reads JAX's key before JAX steps
    a = next(jloop)
    assert a[3] == b[3], k
    actions.append(a[3])
  assert len(set(actions)) == 3
  state = tactor.get_state()
  tactor.set_state(state)


# --- utils: profiling, pytree, schedules ---------------------------------------


def test_phase_timer_trace_and_helpers_match_jax(tmp_path):
  """PhaseTimer's summary has JAX's keys and counts (CPU tensors need no
  fence); trace() writes a Chrome trace that holds the block's ops and
  yields the profiler; tree_replace and LinearSchedule as JAX's."""
  import dataclasses as dc
  from dqn_zoo_tpu.utils import profiling as jprofiling
  from dqn_zoo_tpu.utils.pytree import tree_replace as jtree_replace
  from dqn_zoo_tpu.utils.schedules import LinearSchedule as JLinear
  from dqn_zoo_torch.utils import profiling
  from dqn_zoo_torch.utils.pytree import tree_replace
  from dqn_zoo_torch.utils.schedules import LinearSchedule

  timers = (jprofiling.PhaseTimer(), profiling.PhaseTimer())
  for timer, x in zip(timers, (jnp.ones(3), torch.ones(3))):
    for name in ("a", "b", "a"):
      with timer(name, block_on=x):
        pass
  want, got = (t.summary() for t in timers)
  assert got.keys() == want.keys() == {"a", "b"}
  for k in want:
    assert got[k].keys() == want[k].keys()
    assert got[k]["count"] == want[k]["count"]

  with profiling.trace(str(tmp_path)) as prof:
    torch.ones(64).mul(2).sum()
  assert prof.trace_path.startswith(str(tmp_path))
  text = open(prof.trace_path).read()
  assert '"traceEvents"' in text and "aten::mul" in text
  assert any(e.key == "aten::mul" for e in prof.key_averages())

  @dc.dataclass(frozen=True)
  class Config:
    a: int = 1
    b: int = 2
  assert tree_replace(Config(), b=5) == jtree_replace(Config(), b=5)
  step = ts_lib.restart(1)
  assert tree_replace(step, observation=2).observation == 2
  with pytest.raises(TypeError):
    tree_replace(3, a=1)

  kw = dict(begin_value=1.0, end_value=0.1, begin_t=80, decay_steps=400)
  for t in (0, 80, 81, 123, 479, 480, 10_000):
    assert float(LinearSchedule(**kw)(t)) == float(JLinear(**kw)(t)), t
  with pytest.raises(ValueError):
    LinearSchedule(1.0, 0.0, 0)
