"""The program's span-and-counter recorder (dqn_zoo_torch/utils/profiling.py)
and its spans inside the engines' supersteps, on small CPU engines; two
card tests (marked `cuda`, skipped without a card; with one, and without
JAX, which tests/conftest.py imports, run them with
  python -m pytest --noconftest -m cuda tests/test_torch_spans.py -q).
"""

import dataclasses
import json
import time
import warnings

import numpy as np
import pytest
import torch

from dqn_zoo_torch.engine.host_env import HostEnvEngine
from dqn_zoo_torch.envs.cpp_bridge import DeviceGroupOutput, HostGroupOutput
from dqn_zoo_torch.run.train import build_config, build_engine
from dqn_zoo_torch.utils import profiling
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SMALL_TAUS = dict(tau_samples_policy=8, tau_samples_s_tm1=8,
                  tau_samples_s_t=8)
ROOT_KIDS = ["draw", "act", "insert", "env.step", "prep", "sync.gate",
             "learn", "target_swap", "telemetry"]


@pytest.fixture(autouse=True)
def _recorder_off_and_empty():
  """Each test starts and ends with the process's recorder off and
  drained."""
  profiling.drain()
  yield
  assert not profiling.RECORDER.on
  profiling.drain()


def _engine(agent="iqn", device="cpu", **config):
  overrides = dict(SMALL_TAUS) if agent == "iqn" else {}
  eng = build_engine(agent, "pong", 4, 160, 0, "throughput",
                     num_iterations=1, num_train_frames=10_000,
                     min_replay_capacity_fraction=0.1,
                     spec_overrides=overrides, device=device)
  if config:
    eng = type(eng)(dataclasses.replace(eng.config, **config), device=device)
  return eng


def _learning_state(eng, seed=0):
  """A state whose next superstep learns (the min fill is 16 rows)."""
  state = eng.init(seed)
  while state.telemetry.learn_steps == 0:
    state = eng.superstep(state)
  return state


def _recorded(step, *args, **kw):
  with profiling.recording():
    out = step(*args, **kw)
  return out, profiling.drain()


def _tree(spans):
  """{span name: [child names in order]}, children by parent id."""
  by_id = {s.id: s for s in spans}
  kids = {}
  for s in spans:
    if s.parent in by_id:
      kids.setdefault(by_id[s.parent].name, []).append(s.name)
  return kids


@pytest.mark.parametrize("agent", ["iqn", "prioritized"])
def test_a_learning_superstep_records_the_span_tree(agent):
  eng = _engine(agent)
  state = _learning_state(eng)
  new, got = _recorded(eng.superstep, state)
  assert new.telemetry.learn_steps == state.telemetry.learn_steps + 1
  roots = [s for s in got.spans if s.parent == -1]
  assert [r.name for r in roots] == ["superstep"]
  assert {s.step for s in got.spans} == {state.superstep}
  kids = _tree(got.spans)
  assert kids["superstep"] == ROOT_KIDS
  assert kids["env.step"] == ["sync.reset"]  # no env needed a reset
  learn = ["learn.sample", "learn.loss", "learn.backward", "learn.optimizer"]
  if agent == "prioritized":
    learn.append("learn.priorities")
  assert kids["learn"] == learn
  # Each span lies inside its parent, and siblings follow one another.
  by_id = {s.id: s for s in got.spans}
  for s in got.spans:
    assert s.start_ns <= s.end_ns
    if s.parent in by_id:
      p = by_id[s.parent]
      assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
  sibs = [s for s in got.spans if s.parent == roots[0].id]
  assert all(a.end_ns <= b.start_ns for a, b in zip(sibs, sibs[1:]))
  assert got.counters == {"host_syncs": 2}
  assert got.dropped == 0 and len(got.anchors) == 2


def test_the_reset_burn_runs_only_on_a_superstep_that_needs_a_reset():
  eng = _engine()
  state = eng.init(1)
  seen = []
  for i in range(4):
    if i == 3:  # one stream's episode ended
      needs = torch.zeros_like(state.env.needs_reset)
      needs[2] = True
      state = state._replace(env=state.env._replace(needs_reset=needs))
    needed = bool(state.env.needs_reset.any())
    state, got = _recorded(eng.superstep, state)
    burns = [s for s in got.spans if s.name == "env.reset_burn"]
    assert len(burns) == needed
    assert got.counters.get("env.reset_branch", 0) == needed
    if needed:
      assert _tree(got.spans)["env.step"] == ["sync.reset", "env.reset_burn"]
    seen.append(needed)
  assert seen == [True, False, False, True]  # all start in needs_reset


def test_eval_superstep_spans():
  eng = _engine()
  params = eng.init(0).online_params
  state = eng.eval_init(3, num_envs=2)
  state, got = _recorded(eng.eval_superstep, params, state)
  kids = _tree(got.spans)
  assert kids["eval.superstep"] == ["draw", "act", "env.step", "prep"]
  root = next(s for s in got.spans if s.name == "eval.superstep")
  assert {s.step for s in got.spans} == {root.id}
  assert got.counters == {"host_syncs": 1, "env.reset_branch": 1}


class _Farm:
  """A host env of B streams whose groups are made up here; `upload`
  copies them to the CPU device as the farm's does."""

  def __init__(self, b=4, num_actions=6):
    self.batch_size, self.num_actions = b, num_actions
    self.device = torch.device("cpu")
    self.rng = np.random.RandomState(0)

  def step(self, actions):
    b = self.batch_size
    first = self.rng.rand(b) < 0.05
    return HostGroupOutput(
        obs84=self.rng.randint(0, 256, (b, 84, 84)).astype(np.uint8),
        reward_sum=self.rng.randint(-1, 2, b).astype(np.float32),
        discount_prod=np.ones(b, np.float32), is_first=first,
        is_last=np.zeros(b, bool), is_truncated=np.zeros(b, bool),
        lives=np.zeros(b, np.int32), frames_used=np.full(b, 4, np.int32))

  def upload(self, g):
    t = torch.from_numpy
    return DeviceGroupOutput(t(g.obs84).clone(), t(g.reward_sum).clone(),
                             t(g.discount_prod).clone(), t(g.is_first).clone(),
                             t(g.is_last).clone(), t(g.frames_used).clone())


def _host_engine():
  cfg = build_config("iqn", "pong", 4, 160, 0, "throughput",
                     num_iterations=1, num_train_frames=10_000,
                     min_replay_capacity_fraction=0.1,
                     spec_overrides=SMALL_TAUS)
  farm = _Farm()
  return HostEnvEngine(cfg, farm, device="cpu"), farm


def test_the_host_engine_reads_the_device_once_a_superstep():
  eng, farm = _host_engine()
  state = eng.init(0)
  actions = np.zeros(4, np.int32)
  while state.telemetry.learn_steps == 0:
    state, actions = eng.step(state, farm.step(actions))
  (new, actions), got = _recorded(eng.step, state, farm.step(actions))
  assert new.telemetry.learn_steps == state.telemetry.learn_steps + 1
  assert actions.dtype == np.int32 and actions.shape == (4,)
  assert got.counters == {"host_syncs": 1}
  assert _tree(got.spans)["superstep"] == [
      "draw", "upload", "act", "insert", "sync.gate", "learn", "target_swap",
      "telemetry"]


@pytest.mark.parametrize("engine", ["engine", "overlap", "host"])
def test_timings_keep_their_keys_and_fit_the_superstep(engine):
  if engine == "host":
    eng, farm = _host_engine()
    state, actions = eng.init(0), np.zeros(4, np.int32)
    group = farm.step(actions)
    step = lambda s, timings: eng.step(s, group, timings=timings)[0]
    keys = {"upload", "act", "insert", "learn"}
  else:
    eng = _engine(overlap_env_learn=engine == "overlap")
    state = eng.init(0)
    step = lambda s, timings: eng.superstep(s, timings=timings)
    keys = {"act", "insert", "env_prep", "learn"}
  for _ in range(8):  # past the min fill: the learn stage learns
    timings = {}
    t0 = time.perf_counter()
    state = step(state, timings)
    wall = time.perf_counter() - t0
    assert set(timings) == keys
    assert all(v > 0 for v in timings.values())
    assert sum(timings.values()) <= wall
  assert state.telemetry.learn_steps > 0
  assert profiling.drain().spans == []  # fenced, not recorded


def test_off_the_recorder_keeps_nothing_and_hands_out_one_object():
  eng = _engine()
  state = eng.superstep(eng.init(0))
  assert not profiling.RECORDER.on
  assert profiling.span("a") is profiling.span("b") is profiling.NOOP
  assert profiling.root("superstep", 0) is profiling.NOOP
  profiling.count("host_syncs")
  profiling.end()
  got = profiling.drain()
  assert got.spans == [] and got.counters == {} and got.anchors == []
  assert state.superstep == 1


def test_the_buffer_keeps_the_newest_spans_and_counts_the_dropped():
  rec = profiling.Recorder(capacity=4)
  with rec.recording():
    with rec.span("outer", step=7):
      for i in range(5):
        with rec.span(f"s{i}"):
          pass
  got = rec.drain()
  assert [s.name for s in got.spans] == ["outer", "s2", "s3", "s4"]
  assert got.dropped == 2 and all(s.step == 7 for s in got.spans)
  assert rec.drain().dropped == 0


def test_spans_map_onto_the_profilers_clock_within_a_millisecond():
  prof = torch.profiler.profile(
      activities=[torch.profiler.ProfilerActivity.CPU])
  prof.start()
  with profiling.recording():
    with profiling.span("outer"):
      with torch.profiler.record_function("block"):
        time.sleep(0.01)
        torch.ones(64).mul(2).sum()
  prof.stop()
  got = profiling.drain()
  span = got.spans[0]
  block = next(e for e in prof.profiler.kineto_results.events()
               if e.name() == "block")
  start = profiling.profiler_ns(span.start_ns, got.anchors)
  end = profiling.profiler_ns(span.end_ns, got.anchors)
  block_end = block.start_ns() + block.duration_ns()
  assert abs(block.start_ns() - start) < 1e6
  assert abs(block_end - end) < 1e6
  assert start - 1e5 <= block.start_ns() <= block_end <= end + 1e5


def test_a_superstep_under_a_profiler_records_its_spans():
  """Roots turn the recorder on while torch.profiler records, and off at
  the first root after it stops."""
  eng = _engine()
  state = eng.superstep(eng.init(0))
  with torch.profiler.profile(
      activities=[torch.profiler.ProfilerActivity.CPU]):
    state = eng.superstep(state)
    assert profiling.RECORDER.on
  state = eng.superstep(state)
  assert not profiling.RECORDER.on
  got = profiling.drain()
  assert [s.name for s in got.spans if s.parent == -1] == ["superstep"]
  assert got.counters["host_syncs"] == 2 and len(got.anchors) == 2


def test_trace_writes_the_spans_into_its_chrome_trace(tmp_path):
  eng = _engine()
  state = eng.init(0)
  with profiling.trace(str(tmp_path)) as prof:
    state = eng.superstep(state)
  doc = json.loads(open(prof.trace_path).read())
  spans = [e for e in doc["traceEvents"] if e.get("cat") == "program_span"]
  assert [e["name"] for e in spans][:3] == ["superstep", "draw", "act"]
  assert {e["args"]["step"] for e in spans} == {0}
  # The superstep's ops lie inside its span, within a millisecond.
  root = spans[0]
  ops = [e for e in doc["traceEvents"] if e.get("cat") == "cpu_op"]
  assert ops
  assert all(root["ts"] - 1e3 <= e["ts"] <= root["ts"] + root["dur"] + 1e3
             for e in ops)
  assert profiling.drain().spans == []


# --- on the card ---------------------------------------------------------------


@pytest.fixture
def card():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card")
  from dqn_zoo_torch.device import set_numerics
  set_numerics()
  return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("reset", [False, True], ids=["no_reset", "reset"])
def test_every_blocking_read_of_a_superstep_is_counted(card, reset):
  """Under CUDA's sync debug mode, a learning superstep of a small iqn
  engine (with the reset branch, or without) warns once for each read that
  the host_syncs counter counts."""
  eng = _engine(device=card)
  state = _learning_state(eng)
  needs = torch.zeros_like(state.env.needs_reset)
  needs[1] = reset
  state = state._replace(env=state.env._replace(needs_reset=needs))
  torch.cuda.synchronize()
  with warnings.catch_warnings(record=True) as caught:
    warnings.simplefilter("always")
    torch.cuda.set_sync_debug_mode("warn")
    try:
      with profiling.recording():
        state = eng.superstep(state)
    finally:
      torch.cuda.set_sync_debug_mode(0)
  syncs = [f"{w.filename}:{w.lineno}" for w in caught
           if "called a synchronizing CUDA operation" in str(w.message)]
  got = profiling.drain()
  assert got.counters["host_syncs"] == 2
  assert got.counters.get("env.reset_branch", 0) == reset
  assert len(syncs) == got.counters["host_syncs"], syncs


@pytest.mark.cuda
def test_the_window_gather_kernel_starts_after_its_sample_span_opens(card):
  """The clock mapping on the card: in a profiled stretch, each K1 launch's
  device start lies after its superstep's learn.sample span opened."""
  eng = _engine(device=card)
  state = _learning_state(eng)
  torch.cuda.synchronize()
  prof = torch.profiler.profile(
      activities=[torch.profiler.ProfilerActivity.CUDA])
  prof.start()
  for _ in range(4):
    state = eng.superstep(state)
  torch.cuda.synchronize()
  prof.stop()
  state = eng.superstep(state)  # the recorder follows the profiler off
  got = profiling.drain()
  samples = sorted(profiling.profiler_ns(s.start_ns, got.anchors)
                   for s in got.spans if s.name == "learn.sample")
  k1 = sorted(e.start_ns() for e in prof.profiler.kineto_results.events()
              if "gather_windows_kernel" in e.name()
              and e.device_type() == torch.autograd.DeviceType.CUDA)
  assert len(samples) == 4 and len(k1) == 4
  lags_us = [(k - s) / 1e3 for s, k in zip(samples, k1)]
  assert all(lag > 0 for lag in lags_us), lags_us
  assert all(k < s for k, s in zip(k1, samples[1:])), lags_us
