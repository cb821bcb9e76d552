"""Training CLI (port of dqn_zoo_tpu/run/train.py).

Usage: python -m dqn_zoo_torch.run.train --agent=dqn --environment_name=pong

The reference's run protocol: iterations of (train phase, eval phase),
iteration 0 eval-only, one CSV row and one log line per iteration with the
reference's 13 fields plus `eval_frames`. Flag names are the JAX CLI's;
flags of parts not ported yet (checkpoints, the PIL resize, multi-device)
raise when set. Agents: dqn, double_q, prioritized and iqn (each also has
its runner, `python -m dqn_zoo_torch.run.agents.<agent>`). Games: pong and
catch. Runs on CUDA unless --device=cpu.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import logging
import math
from typing import Optional, Sequence

from dqn_zoo_torch.agents import all_agent_names, get_agent
from dqn_zoo_torch.engine import Engine, EngineConfig
from dqn_zoo_torch.envs.vector import VectorEnvConfig
from dqn_zoo_torch.run import atari_data
from dqn_zoo_torch.run.trackers import StepRateTracker
from dqn_zoo_torch.run.writers import CsvWriter, NullWriter

_SPEC_FLOATS = (
    "learning_rate", "optimizer_epsilon", "exploration_epsilon_begin_value",
    "exploration_epsilon_end_value", "exploration_epsilon_decay_frame_fraction",
    "eval_exploration_epsilon", "grad_error_bound", "max_global_grad_norm",
    "priority_exponent", "importance_sampling_exponent_begin_value",
    "importance_sampling_exponent_end_value", "uniform_sample_probability",
    "huber_param")
_SPEC_INTS = ("target_network_update_period", "learn_period", "n_steps",
              "tau_latent_dim", "tau_samples_policy", "tau_samples_s_tm1",
              "tau_samples_s_t")
# Flag name -> AgentSpec field, where they differ.
_SPEC_FIELD = {
    "exploration_epsilon_begin_value": "exploration_epsilon_begin",
    "exploration_epsilon_end_value": "exploration_epsilon_end",
    "n_steps": "n_step",
    "importance_sampling_exponent_begin_value": "importance_sampling_begin",
    "importance_sampling_exponent_end_value": "importance_sampling_end",
}


def _bool(text: str) -> bool:
  """absl's spellings of a boolean flag's value."""
  low = text.lower()
  if low in ("1", "true", "t", "yes", "y"):
    return True
  if low in ("0", "false", "f", "no", "n"):
    return False
  raise argparse.ArgumentTypeError(f"not a boolean: {text!r}")


def build_engine(agent_name: str, game: str, num_envs: int,
                 replay_capacity: int, batch_size: int = 0,
                 replay_ratio_mode: str = "throughput",
                 max_frames_per_episode: int = 108000,
                 num_iterations: int = 200,
                 num_train_frames: int = int(1e6),
                 min_replay_capacity_fraction: float = -1.0,
                 spec_overrides: dict | None = None,
                 resize_method: str = "fast",
                 device=None) -> Engine:
  """Engine factory shared by the CLI, tests and chip_smoke.py.

  Keeps the reference's replay ratio (batch_size samples per learn_period
  frames) for any number of env streams: parity mode takes the reference
  batch and more updates; throughput mode one big batch per superstep with
  the learning rate scaled by sqrt(batch / reference batch)."""
  spec = get_agent(agent_name)
  if spec_overrides:
    spec = dataclasses.replace(spec, **spec_overrides)
  if min_replay_capacity_fraction >= 0:
    spec = dataclasses.replace(
        spec, min_replay_capacity_fraction=min_replay_capacity_fraction)
  b = num_envs
  samples_per_superstep = max(1, round(4 * b * spec.batch_size
                                       / spec.learn_period))
  if batch_size <= 0:
    if replay_ratio_mode == "parity":
      batch_size = spec.batch_size
    else:
      batch_size = max(spec.batch_size, samples_per_superstep)
  updates = max(1, round(samples_per_superstep / batch_size))
  learn_every = max(1, round(batch_size / samples_per_superstep))
  if replay_ratio_mode == "throughput" and batch_size > spec.batch_size:
    scale = (batch_size / spec.batch_size) ** 0.5
    spec = dataclasses.replace(spec, learning_rate=spec.learning_rate * scale)
  slots = max(replay_capacity // b, spec.n_step + 5)
  return Engine(EngineConfig(
      agent=spec,
      game=game,
      num_envs=b,
      slots_per_stream=slots,
      batch_size=batch_size,
      learn_every=learn_every,
      updates_per_learn=updates,
      total_train_frames=num_iterations * num_train_frames,
      env_config=VectorEnvConfig(episode_frame_cap=max_frames_per_episode),
      resize_method=resize_method,
  ), device=device)


def _parser() -> argparse.ArgumentParser:
  p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  add = p.add_argument
  add("--agent", default="dqn", help=f"One of {all_agent_names()}")
  add("--environment_name", default="pong")
  add("--num_envs", type=int, default=128)
  add("--replay_capacity", type=int, default=int(1e6))
  add("--min_replay_capacity_fraction", type=float, default=-1.0)
  add("--batch_size", type=int, default=0)
  add("--max_frames_per_episode", type=int, default=108000)
  add("--num_iterations", type=int, default=200)
  add("--num_train_frames", type=int, default=int(1e6))
  add("--num_eval_frames", type=int, default=int(5e5))
  add("--seed", type=int, default=1)
  add("--results_csv_path", default="/tmp/results.csv")
  add("--checkpoint_path", default="")
  add("--replay_ratio_mode", default="throughput",
      choices=["parity", "throughput"])
  add("--resize_method", default="fast", choices=["fast", "pil"])
  add("--eval_num_envs", type=int, default=0)
  add("--mesh_devices", type=int, default=0)
  add("--device", default="cuda", help="cuda (default) or cpu.")
  add("--compute_dtype", default="",
      help="float32 (default); bfloat16 is not ported yet.")
  add("--num_action_repeats", type=int, default=0,
      help="Raw frames per agent step; only 4 (or 0 = 4).")
  add("--num_stacked_frames", type=int, default=0,
      help="Observation stack depth; only 4 (or 0 = 4).")
  for name in _SPEC_FLOATS:
    add(f"--{name}", type=float, default=None)
  for name in _SPEC_INTS:
    add(f"--{name}", type=int, default=0)
  # A boolean as absl spells it: --normalize_weights[=true|false] or
  # --nonormalize_weights; unset keeps the agent's default.
  add("--normalize_weights", type=_bool, nargs="?", const=True, default=None)
  add("--nonormalize_weights", dest="normalize_weights",
      action="store_false")
  return p


def _spec_overrides(args) -> dict:
  """AgentSpec overrides from the flags, as the JAX CLI collects them: unset
  flags (None, or <= 0 for the ints) stay out, so agent defaults survive."""
  if args.num_action_repeats not in (0, 4):
    raise ValueError("num_action_repeats: only 4 is supported; got "
                     f"{args.num_action_repeats}.")
  if args.num_stacked_frames not in (0, 4):
    raise ValueError("num_stacked_frames: only 4 is supported; got "
                     f"{args.num_stacked_frames}.")
  if args.compute_dtype not in ("", "float32"):
    raise NotImplementedError("--compute_dtype: the port computes in float32 "
                              f"only; got {args.compute_dtype!r}.")
  out = {}
  for name in _SPEC_FLOATS:
    if getattr(args, name) is not None:
      out[_SPEC_FIELD.get(name, name)] = getattr(args, name)
  for name in _SPEC_INTS:
    if getattr(args, name) > 0:
      out[_SPEC_FIELD.get(name, name)] = getattr(args, name)
  if args.normalize_weights is not None:
    out["normalize_weights"] = args.normalize_weights
  if args.compute_dtype:
    out["compute_dtype"] = args.compute_dtype
  return out


def main(argv: Optional[Sequence[str]] = None) -> None:
  args = _parser().parse_args(argv)
  if args.checkpoint_path:
    raise NotImplementedError("checkpoint/resume is not ported yet.")
  if args.mesh_devices:
    raise NotImplementedError("--mesh_devices is not ported yet.")
  engine = build_engine(
      args.agent, args.environment_name, args.num_envs, args.replay_capacity,
      args.batch_size, args.replay_ratio_mode, args.max_frames_per_episode,
      args.num_iterations, args.num_train_frames,
      args.min_replay_capacity_fraction, spec_overrides=_spec_overrides(args),
      resize_method=args.resize_method, device=args.device)
  writer = CsvWriter(args.results_csv_path) if args.results_csv_path \
      else NullWriter()
  state = engine.init(args.seed)

  b = engine.config.num_envs
  train_supersteps = max(1, args.num_train_frames // (4 * b))
  eval_envs = args.eval_num_envs
  if eval_envs <= 0:
    eval_envs = max(1, args.num_eval_frames
                    // max(1, args.max_frames_per_episode))
  eval_envs = min(eval_envs, b)
  eval_supersteps = max(1, args.num_eval_frames // (4 * eval_envs))

  for iteration in range(args.num_iterations + 1):
    # --- train phase (iteration 0 is eval-only).
    logging.info("Training iteration %d.", iteration)
    n = 0 if iteration == 0 else train_supersteps
    state = engine.reset_telemetry(state)
    rate = StepRateTracker()
    rate.update(0)
    frames_before = state.env_frames
    state = engine.run(state, n)
    train_m = engine.metrics(state)
    rate.update(train_m.env_frames - frames_before)
    train_rate = rate.get()["step_rate"] if n else float("nan")

    # --- eval phase: the frame budget, extended up to 3x until an episode
    # completes, in chunks of at most 100 supersteps.
    logging.info("Evaluation iteration %d.", iteration)
    estate = engine.eval_init(args.seed * 1_000_003 + iteration,
                              num_envs=eval_envs)
    erate = StepRateTracker()
    erate.update(0)
    done = 0
    while done < eval_supersteps or (
        done < 3 * eval_supersteps and float(estate.completed_count) == 0):
      cap = eval_supersteps if done < eval_supersteps else 3 * eval_supersteps
      k = min(100, cap - done)
      estate = engine.eval_run(state.online_params, estate, k)
      done += k
    eval_frames = int(estate.env_frames)
    erate.update(eval_frames)
    eval_episodes = int(estate.completed_count)
    eval_return = (float(estate.completed_return_sum) / eval_episodes
                   if eval_episodes else float("nan"))

    human_norm = atari_data.get_human_normalized_score(
        args.environment_name, eval_return)
    capped = min(1.0, human_norm) if not math.isnan(human_norm) else human_norm
    train_return = train_m.mean_episode_return if n else float("nan")
    log_output = [
        ("iteration", iteration, "%3d"),
        ("frame", iteration * args.num_train_frames, "%5d"),
        ("eval_episode_return", eval_return, "% 2.2f"),
        ("train_episode_return", train_return, "% 2.2f"),
        ("eval_num_episodes", eval_episodes, "%3d"),
        ("train_num_episodes", int(train_m.episodes), "%3d"),
        ("eval_frame_rate", erate.get()["step_rate"], "%4.0f"),
        ("train_frame_rate", train_rate, "%4.0f"),
        ("train_exploration_epsilon", train_m.exploration_epsilon, "%.3f"),
        ("train_state_value", train_m.state_value_ewma, "%.3f"),
        ("normalized_return", human_norm, "%.3f"),
        ("capped_normalized_return", capped, "%.3f"),
        ("human_gap", 1.0 - capped, "%.3f"),
        ("eval_frames", eval_frames, "%d"),
    ]
    logging.info(", ".join(("%s: " + f) % (n_, v) for n_, v, f in log_output))
    writer.write(collections.OrderedDict((n_, v) for n_, v, _ in log_output))
  writer.close()


def cli(argv: Optional[Sequence[str]] = None) -> None:
  """`main` with INFO logging on, as the command line runs it."""
  logging.basicConfig(level=logging.INFO,
                      format="%(asctime)s %(levelname)s %(message)s")
  main(argv)


if __name__ == "__main__":
  cli()
