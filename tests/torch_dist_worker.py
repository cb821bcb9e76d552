"""One rank of tests/test_torch_distributed.py's gloo process groups.

  python tests/torch_dist_worker.py MODE RANK WORLD DIR

The ranks meet through a FileStore in DIR, where the test also leaves
their inputs (config.json, converted states, draws, the JAX side's
results) and reads what they write. Imports torch and dqn_zoo_torch only,
never JAX. Prints RANK_OK when its mode's checks passed; an assertion
that fails exits non-zero with its traceback.
"""

import dataclasses
import json
import math
import os
import sys

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from dqn_zoo_torch.agents import get_agent  # noqa: E402
from dqn_zoo_torch.engine import EngineConfig  # noqa: E402
from dqn_zoo_torch.envs.vector import VectorEnvConfig  # noqa: E402
from dqn_zoo_torch.parallel import DistributedTrainer  # noqa: E402
from dqn_zoo_torch.replay import device_replay as dr  # noqa: E402
from dqn_zoo_torch.run import train  # noqa: E402
from dqn_zoo_torch.run.checkpoint import (RankCheckpoint,  # noqa: E402
                                          flatten_state, restore_state)
from dqn_zoo_torch.utils.pytree import leaves  # noqa: E402

ROW_FIELDS = ("stack_count", "action", "reward", "discount", "is_terminal",
              "row_t")


def trainer_from(workdir: str) -> DistributedTrainer:
  """The DistributedTrainer that DIR/config.json describes, on the CPU."""
  with open(os.path.join(workdir, "config.json")) as f:
    c = json.load(f)
  spec = dataclasses.replace(get_agent(c["agent"]), **c["overrides"])
  cfg = EngineConfig(agent=spec, env_config=VectorEnvConfig(
      episode_frame_cap=c["episode_frame_cap"]), pmap_axis="d", **c["engine"])
  return DistributedTrainer(cfg, device="cpu")


def flat(tree) -> torch.Tensor:
  return torch.cat([p.detach().reshape(-1) for p in leaves(tree)])


def _load(workdir, name, **kw):
  return torch.load(os.path.join(workdir, name), weights_only=False, **kw)


def _u8_close(a, b, what):
  """Observations: the port's resize sums in another order than
  jax.image.resize, so a pixel may differ by 1 (K2's tolerance)."""
  diff = (a.to(torch.int32) - b.to(torch.int32)).abs()
  assert int(diff.max()) <= 1, what
  assert float((diff == 0).float().mean()) > 0.98, what


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
  """Equal bit for bit, NaNs included."""
  bits = lambda x: x.reshape(-1).contiguous().view(torch.uint8)
  return a.dtype == b.dtype and a.shape == b.shape and torch.equal(bits(a),
                                                                   bits(b))


def _gathered(t: torch.Tensor, world: int):
  out = [torch.empty_like(t) for _ in range(world)]
  dist.all_gather(out, t)
  return out


def mode_match(rank, world, workdir):
  """Supersteps from a converted JAX state with JAX's draws, each held to
  the JAX trainer's per-device reference; the ranks' parameters bit for
  bit equal to each other after every superstep."""
  trainer = trainer_from(workdir)
  eng = trainer.engine
  state = restore_state(trainer.init(0), _load(workdir, f"init{rank}.pt"))
  steps = _load(workdir, f"steps{rank}.pt")
  online_ref = _load(workdir, "online.pt", mmap=True)
  swaps = 0
  for i, step in enumerate(steps):
    ref = step["ref"]
    if "value_tree" in step:
      # Prioritized: JAX's trees and max-seen priority before the step (the
      # JAX engine keeps its inserts at priority 1; the port raises them to
      # the max seen), so that both sample the same rows.
      with torch.no_grad():
        for a, b in zip(state.replay.value_tree, step["value_tree"]):
          a.copy_(b)
        state.replay.max_seen_priority.copy_(step["max_seen_priority"])
      before = state.replay.value_tree[0].clone()
    prev_target = flat(state.target_params)
    state = eng.superstep(state, step["draws"])

    for f in ROW_FIELDS:
      assert torch.equal(getattr(state.replay, f), ref[f]), (f, i)
    _u8_close(state.replay.frames, ref["frames"], ("replay frames", i))
    _u8_close(state.stack.frames, ref["stack"], ("stack", i))
    for a, b in zip(state.replay.indicator_tree, ref["indicator_tree"]):
      assert torch.equal(a, b), ("indicator tree", i)
    for name, want in ref["game_state"].items():
      assert torch.equal(getattr(state.env.game_state, name), want), (name, i)
    assert state.env_frames == ref["env_frames"], i
    assert state.replay.t == ref["t"], i
    if "value_tree" in step:
      # The superstep wrote the same leaves as JAX's (the rows it sampled),
      # and left the others exactly as JAX left them. The written values
      # are |td| of observations within ±1 per pixel of JAX's: the
      # single-engine test, tests/test_torch_prioritized.py, holds them.
      got, want = state.replay.value_tree[0], ref["value_tree"]
      written = got != before
      assert torch.equal(written, want != before), i
      assert torch.equal(got[~written], want[~written]), i

    # ε and β at the frame multiplier, from this rank's counters.
    assert eng.exploration_epsilon(state.env_frames) == ref["epsilon"], i
    assert eng.importance_sampling_exponent(
        state.replay.t * eng.config.num_envs) == ref["beta"], i

    # Loss and parameters within the slice test's bounds.
    assert state.telemetry.learn_steps == ref["learn_steps"], i
    if ref["learn_steps"]:
      loss, want = float(state.telemetry.last_loss), ref["last_loss"]
      assert abs(loss - want) <= 1e-3 * abs(want) + 2e-8, (i, loss, want)
    online = flat(state.online_params)
    diff = (online - online_ref[i]).abs()
    assert float(diff.max()) <= 5e-5, (i, float(diff.max()))
    assert float((diff <= 2e-6).float().mean()) >= 0.999, i
    target = flat(state.target_params)
    changed = not torch.equal(target, prev_target)
    assert changed == ref["target_changed"], ("target swap", i)
    if changed:
      assert torch.equal(target, online), i
      swaps += 1

    # The ranks' parameters are the same bits.
    for other in _gathered(online, world):
      assert torch.equal(other, online), ("ranks differ", i)
  assert swaps >= 1 and state.telemetry.learn_steps >= 5, (
      swaps, state.telemetry.learn_steps)


def mode_metrics(rank, world, workdir):
  """metrics and eval_metrics over the ranks against the JAX trainer's, on
  the converted states; then the same after a telemetry reset (no episode
  completed: the in-progress fallback)."""
  trainer = trainer_from(workdir)
  with open(os.path.join(workdir, "jax_metrics.json")) as f:
    want = json.load(f)
  state = restore_state(trainer.init(0), _load(workdir, f"init{rank}.pt"))
  estate = restore_state(trainer.eval_init(0, num_envs=want["eval_envs"]),
                         _load(workdir, f"eval{rank}.pt"))

  def same(got, ref, what):
    assert sorted(got) == sorted(ref), what
    for k, v in ref.items():
      if isinstance(v, float) and math.isnan(v):
        assert math.isnan(got[k]), (what, k)
      else:
        assert got[k] == v, (what, k, got[k], v)

  same(trainer.metrics(state), want["metrics"], "metrics")
  same(trainer.eval_metrics(estate), want["eval"], "eval")
  same(trainer.metrics(trainer.reset_telemetry(state)), want["reset"],
       "after reset")


def mode_checkpoint(rank, world, workdir):
  """RankCheckpoint: a save restored into a template of another seed equals
  the saved state and runs on as it would have; a replay-less restore
  takes the max over ranks of the insert counter and max-seen priority; a
  slot of another world size is refused."""
  trainer = trainer_from(workdir)
  state = trainer.run(trainer.init(3), 6)
  full = RankCheckpoint(os.path.join(workdir, "full"))
  assert full._device == torch.device("cpu")  # gloo's: no device asked for
  full.save(state, 1, {}, train_done=6)
  restored, it, _, done = full.restore(trainer.init(4))
  assert (it, done) == (1, 6)
  want, got = flatten_state(state), flatten_state(restored)
  assert sorted(got) == sorted(want)
  for k, v in want.items():
    assert (_same_bits(got[k], v) if isinstance(v, torch.Tensor)
            else got[k] == v), k
  assert restored.replay.value_tree is restored.replay.indicator_tree
  state = trainer.run(state, 3)
  restored = trainer.run(restored, 3)
  assert torch.equal(flat(state.online_params), flat(restored.online_params))
  assert torch.equal(state.replay.frames, restored.replay.frames)

  # Replay-less: each rank's own insert counter and max-seen priority, the
  # restore takes their max.
  t0 = state.replay.t
  state = state._replace(replay=state.replay._replace(t=t0 + 5 * rank))
  state.replay.max_seen_priority.fill_(1.5 + rank)
  lite = RankCheckpoint(os.path.join(workdir, "lite"))
  train.save_checkpoint(lite, state, 2, {}, 0, checkpoint_replay=False)
  restored, it, _, _ = train.restore_checkpoint(lite, trainer.init(5),
                                                checkpoint_replay=False)
  assert it == 2 and restored.replay.t == t0 + 5 * (world - 1)
  assert float(restored.replay.max_seen_priority) == 1.5 + world - 1
  assert torch.equal(flat(restored.online_params), flat(state.online_params))
  saved = torch.load(lite.state_path(), weights_only=True)
  assert not [k for k in saved if k.startswith("replay.")]
  with open(os.path.join(workdir, "lite", "meta.json")) as f:
    assert json.load(f)["world_size"] == world

  # A slot saved by another number of ranks is refused on every rank.
  dist.barrier()
  if rank == 0:
    meta = full.meta()
    meta["world_size"] = world + 1
    with open(os.path.join(workdir, "full", "meta.json"), "w") as f:
      json.dump(meta, f)
  dist.barrier()
  try:
    full.restore(trainer.init(6))
  except ValueError as e:
    assert "ranks' states" in str(e), e
  else:
    raise AssertionError("a slot of another world size was restored")


def mode_cli(rank, world, workdir):
  """The CLI at --mesh_devices=2 over two iterations, then a resume that
  runs the third: the CSV path is per rank, so that a rank that wrote it
  would show."""
  train.TRAIN_CHUNK = 2  # several fences, budget and save checks a phase
  argv = ["--mesh_devices=2", "--device=cpu", "--agent=dqn",
          "--environment_name=catch", "--num_envs=4", "--replay_capacity=128",
          "--min_replay_capacity_fraction=0.1", "--num_iterations=2",
          "--num_train_frames=128", "--num_eval_frames=64",
          "--max_frames_per_episode=64", "--batch_size=8",
          "--save_interval_seconds=1000",
          f"--results_csv_path={workdir}/results{rank}.csv",
          f"--checkpoint_path={workdir}/ckpt"]
  first = train.main(argv + ["--iterations_per_run=2"])
  assert first.superstep == 8, first.superstep
  final = train.main(argv)
  assert final.superstep == 16, final.superstep
  assert final.telemetry.learn_steps > 0


def mode_gate(rank, world, workdir):
  """The learn gate reads the least replay size over the ranks: while rank
  1's replay is emptied before each superstep, no rank learns, though rank
  0's own replay passed the min fill (a rank learning alone would wait
  forever in the gradient all-reduce); once both have filled, both learn
  the same steps."""
  trainer = trainer_from(workdir)
  eng = trainer.engine
  min_fill = eng.spec.min_replay_capacity_fraction * eng.config.replay_capacity
  state = trainer.init(7)
  for _ in range(14):
    if rank == 1:
      for level in state.replay.indicator_tree:
        level.zero_()
    state = trainer.run(state, 1)
  own = float(dr.replay_size(state.replay))
  sizes = _gathered(torch.tensor([own]), world)
  assert float(sizes[0]) >= min_fill > float(sizes[1]), sizes
  assert state.telemetry.learn_steps == 0
  state = trainer.run(state, 14)
  steps = _gathered(torch.tensor([state.telemetry.learn_steps]), world)
  assert int(steps[0]) == int(steps[1]) > 0, steps


MODES = {"match": mode_match, "metrics": mode_metrics,
         "checkpoint": mode_checkpoint, "cli": mode_cli, "gate": mode_gate}


def main():
  mode, rank, world, workdir = (sys.argv[1], int(sys.argv[2]),
                                int(sys.argv[3]), sys.argv[4])
  torch.set_num_threads(1)
  dist.init_process_group(
      "gloo", store=dist.FileStore(os.path.join(workdir, "store"), world),
      rank=rank, world_size=world)
  try:
    MODES[mode](rank, world, workdir)
  finally:
    dist.destroy_process_group()
  print(f"RANK_OK {rank}", flush=True)


if __name__ == "__main__":
  main()
