"""rainbow/zaxxon on the CPU: supersteps of the port's engine and of the JAX
package's from one JAX state carried across by convert, and the rainbow
runner on zaxxon. Zaxxon has the full 18 actions, so rainbow's noisy
dueling head is at its widest, 18 x 51 atoms; its step draws come from
JAX's key chain (tests/torch_games_jax.py)."""

import csv

from test_torch_breakout import rainbow_supersteps_match_jax

from dqn_zoo_torch.run.agents import run_agent
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def test_rainbow_zaxxon_supersteps_match_jax():
  """test_torch_breakout.py's bounds at 18 actions: rows, the indicator
  tree, the game state and the frame count exact; frames within K2's ±1;
  written priorities within 1e-5; loss rtol 1e-3; parameters within 5e-5;
  at least 4 learn steps."""
  tstate, ref = rainbow_supersteps_match_jax("zaxxon")
  out = tstate.online_params["advantage"]["out"]["mu"]["w"]
  assert tuple(out.shape) == (512, 18 * 51)
  assert int(ref.telemetry.learn_steps) >= 4


def test_rainbow_runner_takes_zaxxon(tmp_path):
  path = tmp_path / "r.csv"
  run_agent("rainbow", ["--device=cpu", "--environment_name=zaxxon",
                        "--num_envs=2", "--replay_capacity=64",
                        "--min_replay_capacity_fraction=0.1",
                        "--batch_size=8", "--num_iterations=1",
                        "--num_train_frames=64", "--num_eval_frames=32",
                        "--max_frames_per_episode=16",
                        f"--results_csv_path={path}"])
  rows = list(csv.DictReader(open(path)))
  assert [int(r["iteration"]) for r in rows] == [0, 1]
  assert float(rows[1]["train_num_episodes"]) > 0
  assert rows[1]["train_state_value"] != "nan"
