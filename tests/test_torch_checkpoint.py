"""Checkpoint/resume of the port (CPU): runs split across legs of the CLI
against an unbroken run, a replay-less restore against the JAX CLI's rule on
a converted JAX state, the uniform replay's shared tree, the CSV writer's
truncation on resume and the lease flags against the JAX CLI's.

The split runs go through `dqn_zoo_torch.run.train.main` in-process, at 2
envs, replay 64 and pong with 16-frame episodes. A leg's wall clock is
replaced by a count of the supersteps it ran (the train module's
`time.monotonic`), and the train chunk is cut to 2 supersteps, so that
--max_run_seconds runs out after a chosen chunk.
"""

import csv
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_prioritized import _per_engines, jax_per_draws
from test_torch_slice import _assert_u8_close

from dqn_zoo_tpu.run import train as jtrain
from dqn_zoo_torch import convert
from dqn_zoo_torch.engine import Engine
from dqn_zoo_torch.engine.superstep import leaves
from dqn_zoo_torch.run import checkpoint as ckpt
from dqn_zoo_torch.run import train as ttrain
from dqn_zoo_torch.run.writers import CsvWriter
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

_ITERATIONS = 2
_BASE = ["--device=cpu", "--environment_name=pong", "--num_envs=2",
         "--replay_capacity=64", "--min_replay_capacity_fraction=0.1",
         "--batch_size=4", f"--num_iterations={_ITERATIONS}",
         "--num_train_frames=64", "--num_eval_frames=32",
         "--max_frames_per_episode=16", "--target_network_update_period=48"]
# 8 supersteps a train phase. iqn's plain head runs at full width on the
# CPU (D = 3136, H = 512): few τ samples.
_AGENT_FLAGS = {
    "dqn": ["--agent=dqn"],
    "prioritized": ["--agent=prioritized"],
    "iqn": ["--agent=iqn", "--tau_samples_policy=2", "--tau_samples_s_tm1=2",
            "--tau_samples_s_t=2"],
    "rainbow": ["--agent=rainbow"],
}
# How each split run ends its legs. A leg's clock counts supersteps and the
# train chunk is 2 of the phase's 8: a budget of 5 runs out after the third
# chunk of iteration 1 and the second of iteration 2 (mid-train saves); of
# 7, after the last chunk of each train phase (saves with train_done = 8,
# then a leg that starts at eval).
_SPLITS = {
    "iterations": ["--iterations_per_run=1"],
    "mid_train": ["--max_run_seconds=5", "--save_interval_seconds=1000"],
    "after_train": ["--max_run_seconds=7"],
}
_RATES = ("train_frame_rate", "eval_frame_rate")


def _same_bits(a, b) -> bool:
  if isinstance(a, torch.Tensor):
    return (a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).contiguous().view(torch.uint8),
        b.reshape(-1).contiguous().view(torch.uint8)))
  return type(a) is type(b) and a == b


def _assert_same_state(got, want):
  """Every tensor equal bit for bit (NaNs included), the generator's state,
  and every counter (env_frames, superstep, learn_steps, replay t)."""
  g, w = ckpt.flatten_state(got), ckpt.flatten_state(want)
  assert sorted(g) == sorted(w)
  differ = [k for k in w if not _same_bits(g[k], w[k])]
  assert not differ, differ


def _rows(path):
  return [{k: v for k, v in r.items() if k not in _RATES}
          for r in csv.DictReader(open(path))]


def _run_legs(argv, path, max_legs=8):
  """Legs of the CLI until the checkpoint's iteration passes the last one,
  as tools/torch_chain_train.sh runs them; returns (final state, legs)."""
  for legs in range(1, max_legs + 1):
    state = ttrain.main(argv)
    if ckpt.TorchCheckpoint(path).meta()["iteration"] > _ITERATIONS:
      return state, legs
  raise AssertionError(f"no end after {max_legs} legs")


@pytest.fixture(scope="module")
def unbroken(tmp_path_factory):
  """One unbroken run per agent: (final state, CSV rows)."""
  runs = {}

  def get(agent):
    if agent not in runs:
      d = tmp_path_factory.mktemp(f"unbroken_{agent}")
      state = ttrain.main(_BASE + _AGENT_FLAGS[agent] + [
          f"--results_csv_path={d / 'r.csv'}"])
      runs[agent] = (state, _rows(d / "r.csv"))
    return runs[agent]

  return get


# Every split of dqn, iqn and prioritized; rainbow, whose CPU steps take the
# longest (6.9 M parameters under Adam), with mid-train saves only.
_SPLIT_RUNS = [(a, s) for a in ("dqn", "iqn", "prioritized")
               for s in sorted(_SPLITS)] + [("rainbow", "mid_train")]


@pytest.mark.parametrize("agent,split", _SPLIT_RUNS,
                         ids=[f"{a}-{s}" for a, s in _SPLIT_RUNS])
def test_split_run_ends_as_the_unbroken_run(agent, split, unbroken, tmp_path,
                                            monkeypatch):
  want_state, want_rows = unbroken(agent)
  ticks = [0]
  run = Engine.run

  def counted_run(self, state, num_supersteps, timings=None):
    ticks[0] += num_supersteps
    return run(self, state, num_supersteps, timings)

  monkeypatch.setattr(Engine, "run", counted_run)
  monkeypatch.setattr(ttrain, "time",
                      types.SimpleNamespace(monotonic=lambda: float(ticks[0])))
  monkeypatch.setattr(ttrain, "TRAIN_CHUNK", 2)
  path = tmp_path / "ck"
  state, legs = _run_legs(
      _BASE + _AGENT_FLAGS[agent] + _SPLITS[split] + [
          f"--results_csv_path={tmp_path / 'r.csv'}",
          f"--checkpoint_path={path}", "--checkpoint_replay=true"], path)
  assert legs == 3
  assert state.telemetry.learn_steps > 0
  _assert_same_state(state, want_state)
  assert _rows(tmp_path / "r.csv") == want_rows


def test_replayless_restore_is_the_jax_cli_rule(tmp_path):
  """A JAX prioritized/catch state after 6 supersteps, carried across by
  convert. JAX's rule (dqn_zoo_tpu/run/train.py:332-345): the state with a
  fresh replay holding the saved insert counter and max-seen priority. The
  port: save without the replay, restore into a fresh engine state. The
  two must be equal; then two supersteps of each engine on JAX's draws
  (the second activates rows inserted after the restore; the min fill is
  not reached) agree within test_prioritized_catch_supersteps_match_jax's
  bounds: replay rows, trees, game state and frame count exact, frames
  within K2's ±1, parameters within 5e-5 with 99.9 % within 2e-6."""
  jeng, teng = _per_engines()
  jstate = jeng.init(jax.random.PRNGKey(4))
  jstep = jax.jit(jeng.superstep)
  for _ in range(6):
    jstate = jstep(jstate)
  # JAX's learn scan drops the max-seen priority (ROADMAP §3): set one, so
  # that the extras carry something other than the initial 1.
  jstate = jstate._replace(replay=jstate.replay._replace(
      max_seen_priority=jnp.float32(1.75)))
  jstate = jax.device_get(jstate)
  assert int(jstate.telemetry.learn_steps) > 0

  fresh = jeng.init(jax.random.PRNGKey(5)).replay
  jrestored = jax.device_get(jstate._replace(replay=fresh._replace(
      t=fresh.t * 0 + int(jstate.replay.t),
      max_seen_priority=(fresh.max_seen_priority * 0
                         + float(jstate.replay.max_seen_priority)))))

  checkpoint = ckpt.TorchCheckpoint(str(tmp_path / "ck"))
  ttrain.save_checkpoint(checkpoint,
                         convert.engine_state_from_jax(teng, jstate),
                         iteration=3, writer_state={}, train_done=2,
                         checkpoint_replay=False)
  meta = checkpoint.meta()
  assert meta["extras"] == {"replay_t": int(jstate.replay.t),
                            "replay_max_priority": 1.75}
  tstate, iteration, _, train_done = ttrain.restore_checkpoint(
      checkpoint, teng.init(9), checkpoint_replay=False)
  assert (iteration, train_done) == (3, 2)
  _assert_same_state(tstate, convert.engine_state_from_jax(teng, jrestored))

  jstate = jrestored
  learned = tstate.telemetry.learn_steps
  for step in range(2):
    draws = jax_per_draws(jeng, jstate)
    jstate = jax.device_get(jstep(jstate))
    tstate = teng.superstep(tstate, draws)
    ref = convert.engine_state_from_jax(teng, jstate)
    for f in ("stack_count", "action", "reward", "discount", "is_terminal",
              "row_t"):
      assert torch.equal(getattr(tstate.replay, f), getattr(ref.replay, f)), \
          (f, step)
    _assert_u8_close(tstate.replay.frames, ref.replay.frames, step)
    for tree in ("indicator_tree", "value_tree"):
      for a, b in zip(getattr(tstate.replay, tree), getattr(ref.replay, tree)):
        assert torch.equal(a, b), (tree, step)
    for name, a, w in zip(ref.env.game_state._fields, tstate.env.game_state,
                          ref.env.game_state):
      assert torch.equal(a, w), (name, step)
    assert tstate.env_frames == ref.env_frames
    assert tstate.replay.t == ref.replay.t
    for tree, ref_tree in ((tstate.online_params, ref.online_params),
                           (tstate.target_params, ref.target_params)):
      diff = torch.cat([(a - w).detach().abs().flatten() for a, w in
                        zip(leaves(tree), leaves(ref_tree))])
      assert float(diff.max()) <= 5e-5, (step, float(diff.max()))
      assert float((diff <= 2e-6).float().mean()) >= 0.999, step
  assert tstate.telemetry.learn_steps == learned
  # Rows inserted after the restore went in at the carried max-seen
  # priority (1.75^α), as JAX's did.
  alpha = teng.rcfg.priority_exponent
  active = tstate.replay.value_tree[0][tstate.replay.indicator_tree[0] > 0]
  assert active.numel() > 0
  assert torch.equal(active, torch.full_like(active, 1.75**alpha))


def test_restore_keeps_the_engines_tensors(tmp_path):
  """A restore copies into the template's tensors: the uniform replay's one
  tree stays one list (value_tree is indicator_tree) and an insert moves
  it; the online parameters keep requires_grad; the optimizer's moments are
  the template's tensors."""
  engine = ttrain.build_engine("dqn", "pong", num_envs=2, replay_capacity=64,
                               batch_size=4, min_replay_capacity_fraction=0.1,
                               device="cpu")
  live = engine.run(engine.init(1), 12)
  checkpoint = ckpt.TorchCheckpoint(str(tmp_path / "ck"))
  checkpoint.save(live, iteration=1, writer_state={})
  template = engine.init(2)
  restored, _, _, _ = checkpoint.restore(template)
  _assert_same_state(restored, live)
  replay = restored.replay
  assert replay.value_tree is replay.indicator_tree
  assert replay.indicator_tree is template.replay.indicator_tree
  assert all(p.requires_grad for p in leaves(restored.online_params))
  for a, b in zip(restored.opt_state.mu + restored.opt_state.nu,
                  template.opt_state.mu + template.opt_state.nu):
    assert a is b
  before = replay.indicator_tree[0].clone()
  after = engine.superstep(restored).replay
  assert after.value_tree is after.indicator_tree
  assert not torch.equal(after.indicator_tree[0], before)
  assert torch.equal(after.indicator_tree[-1],
                     after.indicator_tree[0].sum().reshape(1))


def test_a_save_cut_before_its_meta_file_leaves_the_last_one(tmp_path,
                                                             monkeypatch):
  engine = ttrain.build_engine("dqn", "pong", num_envs=2, replay_capacity=64,
                               device="cpu")
  first = engine.init(1)
  checkpoint = ckpt.TorchCheckpoint(str(tmp_path / "ck"))
  checkpoint.save(first, iteration=1, writer_state={})
  second = engine.run(engine.init(1), 3)

  def cut(*args, **kwargs):
    raise KeyboardInterrupt

  monkeypatch.setattr(json, "dump", cut)
  with pytest.raises(KeyboardInterrupt):
    checkpoint.save(second, iteration=2, writer_state={})
  monkeypatch.undo()
  restored, iteration, _, _ = checkpoint.restore(engine.init(7))
  assert iteration == 1
  _assert_same_state(restored, engine.init(1))


def test_csv_writer_truncates_rows_past_state(tmp_path):
  """Port of tests/test_run_layer.py::test_csv_writer_truncates_rows_past_state:
  a death between writer.write(row_i) and the checkpoint save leaves the
  file one row ahead of the restored state; set_state truncates back so the
  resumed iteration's re-write is not a duplicate."""
  path = str(tmp_path / "r.csv")
  w = CsvWriter(path)
  w.write({"a": 1, "b": 2})
  state = w.get_state()  # snapshot BEFORE the doomed row
  w.write({"a": 3, "b": 4})  # written, but never reached a checkpoint
  w2 = CsvWriter(path)
  w2.set_state(state)
  w2.write({"a": 30, "b": 40})  # resumed run re-emits iteration 1's row
  with open(path) as f:
    rows = list(csv.reader(f))
  assert rows == [["a", "b"], ["1", "2"], ["30", "40"]]
  # Legacy state without the counter: no truncation.
  w3 = CsvWriter(path)
  w3.set_state({"header_written": True, "fieldnames": ["a", "b"]})
  w3.write({"a": 5, "b": 6})
  with open(path) as f:
    assert len(list(csv.reader(f))) == 4


_LEASE_FLAGS = ("checkpoint_path", "checkpoint_replay", "checkpoint_period",
                "iterations_per_run", "max_run_seconds",
                "save_interval_seconds")


@pytest.mark.parametrize("name", _LEASE_FLAGS)
def test_lease_flags_have_the_jax_clis_names_and_defaults(name):
  ours = ttrain._parser().parse_args([])
  assert getattr(ours, name) == jtrain.FLAGS[name].default


@pytest.mark.parametrize("argv,want", [
    (["--checkpoint_replay=false"], False), (["--nocheckpoint_replay"], False),
    (["--checkpoint_replay"], True), (["--checkpoint_replay=true"], True)])
def test_checkpoint_replay_spellings(argv, want):
  assert ttrain._parser().parse_args(argv).checkpoint_replay is want
