"""Training CLI (port of dqn_zoo_tpu/run/train.py).

Usage: python -m dqn_zoo_torch.run.train --agent=dqn --environment_name=pong

The reference's run protocol: iterations of (train phase, eval phase),
iteration 0 eval-only, one CSV row and one log line per iteration with the
reference's 13 fields plus `eval_frames`. Flag names are the JAX CLI's;
--compute_dtype=bfloat16 computes the nets' products on bf16 operands
(nets/core.py; any name but float32 and bfloat16 raises). --mesh_devices=N
trains data-parallel over N ranks under torchrun (run/train_dist.py).
Agents: dqn, double_q, prioritized, iqn, rainbow, c51 and qrdqn (each also
has its runner, `python -m dqn_zoo_torch.run.agents.<agent>`). Games, all
25 of the JAX package's: pong, catch, seaquest, breakout, space_invaders,
freeway, asterix, atlantis, skiing, assault, beam_rider, bowling, boxing,
crazy_climber, demon_attack, enduro, fishing_derby, gopher, ice_hockey,
ms_pacman, phoenix, qbert, star_gunner, tennis and zaxxon.
--resize_method=pil is the reference's exact Pillow resize. Runs on CUDA
unless --device=cpu.

Checkpoint/resume as the JAX CLI has it: --checkpoint_path keeps one slot
of the full state (run/checkpoint.py); a run that finds it resumes there,
partway through an iteration's train phase if it was saved there. The
train phase runs in chunks of at most TRAIN_CHUNK supersteps with a fence
after each, where --max_run_seconds (from the first fence after
engine.init) is checked and mid-train saves are made, so that a training
run can be cut at a wall-clock budget and go on in a new process as if it
had never stopped (tools/torch_chain_train.sh chains such legs).
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import logging
import math
import time
from typing import Optional, Sequence

import torch

from dqn_zoo_torch.agents import all_agent_names, get_agent
from dqn_zoo_torch.engine import Engine, EngineConfig
from dqn_zoo_torch.envs.vector import VectorEnvConfig
from dqn_zoo_torch.nets.core import COMPUTE_DTYPES
from dqn_zoo_torch.run import atari_data
from dqn_zoo_torch.run.checkpoint import NullCheckpoint, TorchCheckpoint
from dqn_zoo_torch.run.trackers import StepRateTracker
from dqn_zoo_torch.run.writers import CsvWriter, NullWriter

_SPEC_FLOATS = (
    "learning_rate", "optimizer_epsilon", "exploration_epsilon_begin_value",
    "exploration_epsilon_end_value", "exploration_epsilon_decay_frame_fraction",
    "eval_exploration_epsilon", "grad_error_bound", "max_global_grad_norm",
    "priority_exponent", "importance_sampling_exponent_begin_value",
    "importance_sampling_exponent_end_value", "uniform_sample_probability",
    "huber_param", "vmax", "noisy_weight_init")
_SPEC_INTS = ("target_network_update_period", "learn_period", "n_steps",
              "tau_latent_dim", "tau_samples_policy", "tau_samples_s_tm1",
              "tau_samples_s_t", "num_atoms", "num_quantiles")
# Supersteps between the train phase's fences (budget checks, saves).
TRAIN_CHUNK = 100
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


def build_config(agent_name: str, game: str, num_envs: int,
                 replay_capacity: int, batch_size: int = 0,
                 replay_ratio_mode: str = "throughput",
                 max_frames_per_episode: int = 108000,
                 num_iterations: int = 200,
                 num_train_frames: int = int(1e6),
                 min_replay_capacity_fraction: float = -1.0,
                 spec_overrides: dict | None = None,
                 resize_method: str = "fast",
                 num_ranks: int = 0) -> EngineConfig:
  """The EngineConfig the CLI, the tests and chip_smoke.py build from the
  flags' counts.

  Keeps the reference's replay ratio (batch_size samples per learn_period
  frames) for any number of env streams: parity mode takes the reference
  batch and more updates; throughput mode one big batch per superstep with
  the learning rate scaled by sqrt(batch / reference batch).
  `num_ranks` > 0: one rank's config for data parallelism over that many
  ranks (parallel/): the counts are global and split evenly (each rank
  takes batch / num_ranks, and the mean gradient sees the whole batch),
  `pmap_axis` is set and the frame multiplier is `num_ranks`, as the JAX
  package's train_dist.build_trainer splits them."""
  ranks = max(1, num_ranks)
  if num_envs % ranks:
    raise ValueError(f"num_envs={num_envs} must divide evenly over "
                     f"mesh_devices={ranks}.")
  spec = get_agent(agent_name)
  if spec_overrides:
    spec = dataclasses.replace(spec, **spec_overrides)
  if min_replay_capacity_fraction >= 0:
    spec = dataclasses.replace(
        spec, min_replay_capacity_fraction=min_replay_capacity_fraction)
  samples_per_superstep = max(1, round(4 * num_envs * spec.batch_size
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
  return EngineConfig(
      agent=spec,
      game=game,
      num_envs=num_envs // ranks,
      slots_per_stream=max(replay_capacity // num_envs, spec.n_step + 5),
      batch_size=max(1, batch_size // ranks),
      learn_every=learn_every,
      updates_per_learn=updates,
      total_train_frames=num_iterations * num_train_frames,
      env_config=VectorEnvConfig(episode_frame_cap=max_frames_per_episode),
      resize_method=resize_method,
      pmap_axis="d" if num_ranks > 0 else None,
      frame_multiplier=ranks,
  )


def build_engine(*args, device=None, **kwargs) -> Engine:
  """The Engine of `build_config(*args, **kwargs)` on one device."""
  return Engine(build_config(*args, **kwargs), device=device)


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
  add("--checkpoint_path", default="", help="Empty disables checkpoints.")
  add("--checkpoint_replay", type=_bool, nargs="?", const=True, default=True,
      help="Include the replay in checkpoints (exact resumes); false leaves "
      "out the multi-GB frame store and the min fill refills it.")
  add("--nocheckpoint_replay", dest="checkpoint_replay", action="store_false")
  add("--checkpoint_period", type=int, default=1,
      help="Save every N iterations (and always before an exit).")
  add("--iterations_per_run", type=int, default=0,
      help="Exit after this many iterations (0 = run to num_iterations).")
  add("--max_run_seconds", type=int, default=0,
      help="Wall-clock budget from the first fence after engine.init; past "
      "it, save (mid-iteration if need be) and exit. 0 disables.")
  add("--save_interval_seconds", type=int, default=0,
      help="Also save mid-train every N seconds (0 = only at iteration ends "
      "and budget exits).")
  add("--replay_ratio_mode", default="throughput",
      choices=["parity", "throughput"])
  add("--resize_method", default="fast", choices=["fast", "pil"])
  add("--eval_num_envs", type=int, default=0)
  add("--mesh_devices", type=int, default=0,
      help="Data-parallel ranks (run under torchrun with as many "
      "processes); 0 = one device.")
  add("--device", default="cuda", help="cuda (default) or cpu.")
  add("--compute_dtype", default="",
      help="float32 (default) or bfloat16.")
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
  if args.compute_dtype not in ("", *COMPUTE_DTYPES):
    raise ValueError(f"--compute_dtype: one of {list(COMPUTE_DTYPES)}; got "
                     f"{args.compute_dtype!r}.")
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


def save_checkpoint(checkpoint, state, iteration: int, writer_state,
                    train_done: int, checkpoint_replay: bool) -> None:
  """Saves as the CLI does: without the replay, its insert counter and
  max-seen priority go into the meta file's extras."""
  extras = None
  if not checkpoint_replay:
    extras = {"replay_t": state.replay.t,
              "replay_max_priority": float(state.replay.max_seen_priority)}
    state = state._replace(replay=None)
  checkpoint.save(state, iteration, writer_state, train_done=train_done,
                  extras=extras)


def restore_checkpoint(checkpoint, template, checkpoint_replay: bool):
  """(state, iteration, writer state, train_done), restored in place into
  `template`, a state that engine.init built. Without the replay the run
  keeps the template's fresh replay, given the saved insert counter and
  max-seen priority (dqn_zoo_tpu/run/train.py:332-345): the IS-exponent
  anneal runs on inserts and new rows enter at the running max; the
  min-fill gate refills the rest."""
  if checkpoint_replay:
    return checkpoint.restore(template)
  replay = template.replay
  state, iteration, writer_state, train_done = checkpoint.restore(
      template._replace(replay=None))
  extras = checkpoint.restore_extras()
  if "replay_t" in extras:
    replay.max_seen_priority.fill_(extras["replay_max_priority"])
    replay = replay._replace(t=int(extras["replay_t"]))
  return (state._replace(replay=replay), iteration, writer_state,
          train_done)


class OneDevice:
  """The iteration protocol's view of one Engine: the methods that
  parallel.DistributedTrainer gives it over ranks, for a single device."""

  rank, world_size = 0, 1

  def __init__(self, engine: Engine):
    self.engine = engine
    self.device = engine.device

  def init(self, seed: int):
    return self.engine.init(seed)

  def run(self, state, num_supersteps: int):
    return self.engine.run(state, num_supersteps)

  def reset_telemetry(self, state):
    return self.engine.reset_telemetry(state)

  def metrics(self, state) -> dict:
    return self.engine.metrics(state)._asdict()

  @staticmethod
  def total_frames(state) -> int:
    return state.env_frames

  def eval_init(self, seed: int, num_envs: int):
    return self.engine.eval_init(seed, num_envs=num_envs)

  def eval_run(self, params, estate, num_supersteps: int):
    return self.engine.eval_run(params, estate, num_supersteps)

  @staticmethod
  def eval_metrics(estate) -> dict:
    episodes = float(estate.completed_count)
    return {"env_frames": int(estate.env_frames), "episodes": episodes,
            "mean_episode_return": (float(estate.completed_return_sum)
                                    / episodes if episodes else math.nan)}

  @staticmethod
  def agree(flag: bool) -> bool:
    return flag


def main(argv: Optional[Sequence[str]] = None):
  """Runs the CLI; returns the final engine state (this rank's, with
  --mesh_devices)."""
  args = _parser().parse_args(argv)
  if args.mesh_devices > 0:
    from dqn_zoo_torch.run import train_dist
    return train_dist.main_dist(args, _spec_overrides(args))
  engine = build_engine(
      args.agent, args.environment_name, args.num_envs, args.replay_capacity,
      args.batch_size, args.replay_ratio_mode, args.max_frames_per_episode,
      args.num_iterations, args.num_train_frames,
      args.min_replay_capacity_fraction, spec_overrides=_spec_overrides(args),
      resize_method=args.resize_method, device=args.device)
  checkpoint = (TorchCheckpoint(args.checkpoint_path)
                if args.checkpoint_path else NullCheckpoint())
  return run_protocol(args, OneDevice(engine), checkpoint)


def run_protocol(args, trainer, checkpoint):
  """The iteration protocol over `trainer` (a OneDevice, or a
  parallel.DistributedTrainer on every rank together); returns the final
  state. Every decision that ends a loop goes through `trainer.agree`
  (over ranks: the first rank's, broadcast), and only the first rank
  writes the CSV and the log."""
  lead = trainer.rank == 0
  log = logging.info if lead else (lambda *a: None)
  writer = (CsvWriter(args.results_csv_path)
            if lead and args.results_csv_path else NullWriter())

  def fence() -> None:
    """Waits for the card, so that the budget clock reads work done, not
    work queued (the superstep's own read-back does not wait for the learn
    launches after it)."""
    if trainer.device.type == "cuda":
      torch.cuda.synchronize(trainer.device)

  state = trainer.init(args.seed)
  fence()
  t_start = time.monotonic()  # the budget clock
  iteration = 0
  train_done = 0  # supersteps already finished inside `iteration`'s train

  if trainer.agree(checkpoint.can_be_restored()):
    log("Restoring checkpoint.")
    state, iteration, writer_state, train_done = restore_checkpoint(
        checkpoint, state, args.checkpoint_replay)
    writer.set_state(writer_state)
    log("Restored at iteration=%d train_done=%d.", iteration, train_done)

  def over_budget() -> bool:
    return trainer.agree(bool(args.max_run_seconds) and
                         time.monotonic() - t_start > args.max_run_seconds)

  last_save = [time.monotonic()]

  def do_save(st, it, td):
    t = time.monotonic()
    save_checkpoint(checkpoint, st, it, writer.get_state(), td,
                    args.checkpoint_replay)
    last_save[0] = time.monotonic()
    log("Checkpoint saved (iteration=%d, train_done=%d) in %.1fs.", it, td,
        last_save[0] - t)

  # --num_envs and the frame budgets are global; the eval streams are split
  # over the ranks, at least one each.
  d = trainer.world_size
  train_supersteps = max(1, args.num_train_frames // (4 * args.num_envs))
  eval_envs = args.eval_num_envs
  if eval_envs <= 0:
    eval_envs = max(1, args.num_eval_frames
                    // max(1, args.max_frames_per_episode))
  eval_envs_per_rank = max(1, max(d, min(eval_envs, args.num_envs)) // d)
  eval_supersteps = max(
      1, args.num_eval_frames // (4 * eval_envs_per_rank * d))

  run_iterations = 0
  while iteration <= args.num_iterations:
    if args.iterations_per_run and run_iterations >= args.iterations_per_run:
      log("iterations_per_run reached; exiting for resume.")
      break
    if over_budget():
      log("max_run_seconds reached; exiting for resume.")
      break
    run_iterations += 1
    # --- train phase (iteration 0 is eval-only), in chunks with a fence
    # after each, where the budget is checked and mid-train saves happen.
    log("Training iteration %d.", iteration)
    n = 0 if iteration == 0 else train_supersteps
    done = min(train_done, n)
    train_done = 0
    if done == 0:
      # A mid-iteration resume keeps the restored telemetry: its phase
      # began in an earlier process.
      state = trainer.reset_telemetry(state)
    elif done < n:
      log("Resuming train phase at superstep %d/%d.", done, n)
    rate = StepRateTracker()
    rate.update(0)
    frames_before = trainer.total_frames(state)
    first_chunk_saved = False
    aborted = False
    while done < n:
      k = min(TRAIN_CHUNK, n - done)
      state = trainer.run(state, k)
      done += k
      fence()
      if done < n and over_budget():
        log("max_run_seconds hit mid-train; saving and exiting.")
        do_save(state, iteration, done)
        aborted = True
        break
      # The first completed chunk of each train phase is saved at once, so
      # that a resumed leg banks progress before its first interval; later
      # ones every save_interval_seconds.
      if done < n and args.save_interval_seconds and trainer.agree(
          not first_chunk_saved
          or time.monotonic() - last_save[0] > args.save_interval_seconds):
        do_save(state, iteration, done)
        first_chunk_saved = True
    if aborted:
      break
    if n and over_budget():
      # Train finished with no budget left for eval: save with
      # train_done = n, so that the next process goes straight to eval.
      log("max_run_seconds hit post-train; saving and exiting.")
      do_save(state, iteration, n)
      break
    train_m = trainer.metrics(state)
    rate.update(train_m["env_frames"] - frames_before)
    train_rate = rate.get()["step_rate"] if n else float("nan")

    # --- eval phase: the frame budget, extended up to 3x until an episode
    # completes, in chunks of at most 100 supersteps. Its seed is a
    # function of (seed, iteration), so eval state is never saved.
    log("Evaluation iteration %d.", iteration)
    estate = trainer.eval_init(args.seed * 1_000_003 + iteration,
                               num_envs=eval_envs_per_rank)
    erate = StepRateTracker()
    erate.update(0)
    done = 0
    while done < eval_supersteps or (
        done < 3 * eval_supersteps
        and trainer.agree(trainer.eval_metrics(estate)["episodes"] == 0)):
      cap = eval_supersteps if done < eval_supersteps else 3 * eval_supersteps
      k = min(100, cap - done)
      estate = trainer.eval_run(state.online_params, estate, k)
      done += k
    em = trainer.eval_metrics(estate)
    erate.update(em["env_frames"])
    eval_episodes = int(em["episodes"])
    eval_return = em["mean_episode_return"]

    human_norm = atari_data.get_human_normalized_score(
        args.environment_name, eval_return)
    capped = min(1.0, human_norm) if not math.isnan(human_norm) else human_norm
    train_return = train_m["mean_episode_return"] if n else float("nan")
    log_output = [
        ("iteration", iteration, "%3d"),
        ("frame", iteration * args.num_train_frames, "%5d"),
        ("eval_episode_return", eval_return, "% 2.2f"),
        ("train_episode_return", train_return, "% 2.2f"),
        ("eval_num_episodes", eval_episodes, "%3d"),
        ("train_num_episodes", int(train_m["episodes"]), "%3d"),
        ("eval_frame_rate", erate.get()["step_rate"], "%4.0f"),
        ("train_frame_rate", train_rate, "%4.0f"),
        ("train_exploration_epsilon", train_m["exploration_epsilon"],
         "%.3f"),
        ("train_state_value", train_m["state_value_ewma"], "%.3f"),
        ("normalized_return", human_norm, "%.3f"),
        ("capped_normalized_return", capped, "%.3f"),
        ("human_gap", 1.0 - capped, "%.3f"),
        ("eval_frames", em["env_frames"], "%d"),
    ]
    log(", ".join(("%s: " + f) % (n_, v) for n_, v, f in log_output))
    writer.write(collections.OrderedDict((n_, v) for n_, v, _ in log_output))
    iteration += 1
    exiting = (args.iterations_per_run
               and run_iterations >= args.iterations_per_run) \
        or iteration > args.num_iterations or over_budget()
    if exiting or iteration % args.checkpoint_period == 0:
      do_save(state, iteration, 0)
  writer.close()
  return state


def cli(argv: Optional[Sequence[str]] = None) -> None:
  """`main` with INFO logging on, as the command line runs it."""
  logging.basicConfig(level=logging.INFO,
                      format="%(asctime)s %(levelname)s %(message)s")
  main(argv)


if __name__ == "__main__":
  cli()
