"""The port's run layer and package rules (CPU): build_engine's replay-ratio
arithmetic against the JAX CLI's, the CLI end to end, the CSV writer, the
device rule and the import rule."""

import csv
import os
import subprocess
import sys

import pytest
import torch

from dqn_zoo_tpu.run import train as jtrain
from dqn_zoo_torch.run import train as ttrain
from dqn_zoo_torch.run.writers import CsvWriter
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("num_envs,mode,batch", [
    (128, "throughput", 0), (4, "parity", 0), (16, "throughput", 64),
    (1, "parity", 0)])
def test_build_engine_matches_jax_replay_ratio(num_envs, mode, batch):
  kw = dict(agent_name="dqn", game="pong", num_envs=num_envs,
            replay_capacity=4096, batch_size=batch, replay_ratio_mode=mode,
            num_iterations=3, num_train_frames=1000)
  jcfg = jtrain.build_engine(**kw).config
  tcfg = ttrain.build_engine(**kw, device="cpu").config
  for f in ("num_envs", "slots_per_stream", "batch_size", "learn_every",
            "updates_per_learn", "total_train_frames"):
    assert getattr(tcfg, f) == getattr(jcfg, f), f
  assert tcfg.agent.learning_rate == jcfg.agent.learning_rate


def test_build_engine_without_a_device_raises_without_cuda():
  if torch.cuda.is_available():
    pytest.skip("this machine has CUDA; the default device is valid here")
  with pytest.raises(RuntimeError, match="CUDA"):
    ttrain.build_engine("dqn", "pong", num_envs=2, replay_capacity=64)


def test_cli_runs_the_iteration_protocol_on_cpu(tmp_path):
  path = tmp_path / "results.csv"
  ttrain.main(["--device=cpu", "--num_envs=2", "--replay_capacity=64",
               "--min_replay_capacity_fraction=0.1", "--num_iterations=2",
               "--num_train_frames=64", "--num_eval_frames=32",
               "--max_frames_per_episode=16", f"--results_csv_path={path}"])
  rows = list(csv.DictReader(open(path)))
  assert [int(r["iteration"]) for r in rows] == [0, 1, 2]
  assert len(rows[0]) == 14 and rows[0]["train_episode_return"] == "nan"
  assert float(rows[2]["train_num_episodes"]) > 0  # 16-frame episodes
  assert int(rows[1]["eval_frames"]) > 0


@pytest.mark.parametrize("flag", ["--mesh_devices=2"])
def test_cli_flags_not_ported_yet_raise(flag, monkeypatch):
  """--mesh_devices=2 is ported; outside a process group of 2 ranks (no
  torchrun variables, no group joined) it raises ValueError."""
  monkeypatch.delenv("WORLD_SIZE", raising=False)
  with pytest.raises(ValueError, match="process group of 2 ranks"):
    ttrain.main(["--device=cpu", "--num_envs=2", "--replay_capacity=64",
                 "--results_csv_path=", flag])


def test_csv_writer_widens_a_resumed_header(tmp_path):
  """A resumed run whose rows gained a column appends it (the reference
  raised 'Fields changed' here)."""
  path = str(tmp_path / "r.csv")
  w = CsvWriter(path)
  w.write({"a": 1, "b": 2})
  state = w.get_state()
  w2 = CsvWriter(path)
  w2.set_state(state)
  w2.write({"a": 3, "b": 4, "c": 5})
  rows = list(csv.DictReader(open(path)))
  assert rows == [{"a": "1", "b": "2", "c": ""},
                  {"a": "3", "b": "4", "c": "5"}]
  with pytest.raises(ValueError):
    w2.write({"b": 1, "a": 2, "c": 3})


def test_port_imports_neither_jax_nor_the_jax_package():
  code = """
import pkgutil, importlib, sys
import dqn_zoo_torch
names = [m.name for m in pkgutil.walk_packages(dqn_zoo_torch.__path__,
                                               'dqn_zoo_torch.')]
for n in names:
  importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'dqn_zoo_tpu', 'optax',
                                    'flax', 'orbax'))
assert len(names) > 20, names
assert not bad, bad
print('ok', len(names))
"""
  env = dict(os.environ, PYTHONPATH=_REPO)
  out = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env,
                       capture_output=True, text=True, timeout=120)
  assert out.returncode == 0, out.stderr
  assert out.stdout.startswith("ok")
