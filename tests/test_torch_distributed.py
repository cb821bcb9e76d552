"""Data parallelism of the port (parallel/distributed.py, run/train_dist.py,
the engine's gradient all-reduce and frame multiplier) against the JAX
package's shard_map trainer (CPU).

The port's ranks are processes (tests/torch_dist_worker.py) in a gloo
group that meets through a FileStore under tmp_path; the JAX side runs
here on conftest's virtual CPU devices and hands the ranks their converted
states, JAX's draws and its results through files in tmp_path. Each wait
on a worker is bounded, and a worker still alive when its test ends is
killed.
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dqn_zoo_tpu.agents import get_agent as jget_agent
from dqn_zoo_tpu.engine import Engine as JEngine
from dqn_zoo_tpu.engine import EngineConfig as JEngineConfig
from dqn_zoo_tpu.envs.vector import VectorEnvConfig as JEnvConfig
from dqn_zoo_tpu.parallel import DistributedTrainer as JTrainer
from dqn_zoo_tpu.parallel import make_mesh
from dqn_zoo_tpu.run import train_dist as jtrain_dist
from dqn_zoo_torch import convert
from dqn_zoo_torch.agents import get_agent
from dqn_zoo_torch.engine import Engine, EngineConfig, EvalState
from dqn_zoo_torch.engine import SuperstepDraws
from dqn_zoo_torch.engine.host_env import HostEnvEngine
from dqn_zoo_torch.envs.cpp_bridge import CppVectorEnv
from dqn_zoo_torch.envs.vector import VectorEnvConfig
from dqn_zoo_torch.prep.atari import FrameStackState
from dqn_zoo_torch.run import checkpoint as tckpt
from dqn_zoo_torch.run import train as ttrain
from dqn_zoo_torch.utils.pytree import leaves
from test_torch_catch import jax_catch_env_draws
from test_torch_replay import _jax_sample_uniforms
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

_HERE = os.path.dirname(os.path.abspath(__file__))
WORLD = 2
SUPERSTEPS = 16
# Two catch streams a rank, a short target period (a swap every three
# supersteps at m = 2), the agents' 5 % min fill (learning from the third
# superstep, so that JAX's per-device gates open together) and a 40-frame
# episode cap (episodes end, and resets run, from the tenth superstep).
ENGINE = dict(game="catch", num_envs=2, slots_per_stream=32, batch_size=8,
              learn_every=1, updates_per_learn=1, total_train_frames=4_000,
              frame_multiplier=WORLD)
OVERRIDES = dict(target_network_update_period=48)
FRAME_CAP = 40


def run_ranks(mode: str, workdir, timeout: float = 240.0) -> None:
  """Runs WORLD worker processes of `mode` and requires each to exit 0 and
  print RANK_OK; stops them all as soon as one fails."""
  env = dict(os.environ, PYTHONPATH=os.pathsep.join(
      [os.path.dirname(_HERE)] + os.environ.get("PYTHONPATH", "").split(
          os.pathsep)), OMP_NUM_THREADS="1")
  logs = [open(os.path.join(workdir, f"{mode}{r}.log"), "w+")
          for r in range(WORLD)]
  procs = [subprocess.Popen(
      [sys.executable, os.path.join(_HERE, "torch_dist_worker.py"), mode,
       str(r), str(WORLD), str(workdir)], stdout=logs[r],
      stderr=subprocess.STDOUT, env=env) for r in range(WORLD)]
  try:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
      codes = [p.poll() for p in procs]
      if all(c is not None for c in codes) or any(c for c in codes):
        break
      time.sleep(0.1)
  finally:
    for p in procs:
      if p.poll() is None:
        p.kill()
      p.wait()
  outs = []
  for f in logs:
    f.seek(0)
    outs.append(f.read())
    f.close()
  for r, (p, out) in enumerate(zip(procs, outs)):
    assert p.returncode == 0 and f"RANK_OK {r}" in out, \
        f"rank {r} ({mode}) exited {p.returncode}:\n{out[-4000:]}"


def _write_config(workdir, agent: str, engine=ENGINE,
                  overrides=OVERRIDES) -> None:
  with open(os.path.join(workdir, "config.json"), "w") as f:
    json.dump(dict(agent=agent, overrides=overrides, engine=engine,
                   episode_frame_cap=FRAME_CAP), f)


def _jax_trainer(agent: str) -> JTrainer:
  spec = dataclasses.replace(jget_agent(agent), **OVERRIDES)
  return JTrainer(JEngineConfig(
      agent=spec, env_config=JEnvConfig(episode_frame_cap=FRAME_CAP),
      pmap_axis="d", **ENGINE), make_mesh(jax.devices()[:WORLD]))


def _converter(agent: str):
  """What convert.dist_state_from_jax reads of a trainer (its engine), built
  here where no process group exists."""
  spec = dataclasses.replace(get_agent(agent), **OVERRIDES)
  cfg = EngineConfig(agent=spec, env_config=VectorEnvConfig(
      episode_frame_cap=FRAME_CAP), **ENGINE)
  return types.SimpleNamespace(engine=Engine(cfg, device="cpu"))


def _jax_draws(jeng, per, prioritized: bool) -> SuperstepDraws:
  """The draws JAX's Engine.superstep makes from one device's state."""
  cfg = jeng.config
  _, act_key, learn_key = jax.random.split(per.rng, 3)
  _, policy_key = jax.random.split(act_key)
  explore_key, uniform_key = jax.random.split(policy_key)
  b = cfg.num_envs
  keys = ([learn_key] if cfg.updates_per_learn == 1
          else jax.random.split(learn_key, cfg.updates_per_learn))
  sample_u = np.stack([
      _jax_sample_uniforms(jax.random.split(k)[0], cfg.batch_size)
      for k in keys])
  if not prioritized:
    sample_u = sample_u[:, 0]
  t = lambda x: torch.from_numpy(np.array(x))
  return SuperstepDraws(
      t(jax.random.uniform(explore_key, (b,))),
      t(jax.random.randint(uniform_key, (b,), 0, jeng.game.num_actions)),
      t(sample_u), jax_catch_env_draws(per.env))


def _device_params(tree, rank: int) -> np.ndarray:
  """Device `rank`'s copy of a replicated JAX parameter tree, flat in the
  port's leaf order (sorted keys, as jax.tree.leaves orders a dict)."""
  return np.concatenate([np.asarray(leaf.addressable_shards[rank].data)
                         .reshape(-1) for leaf in jax.tree.leaves(tree)])


@functools.lru_cache(maxsize=None)
def _jax_run(agent: str):
  """JAX's DistributedTrainer through SUPERSTEPS single-superstep runs on 2
  CPU devices: the initial DistState, and per superstep and device the
  draws, the pre-step value tree (prioritized) and the reference after
  it. The final DistState too."""
  prioritized = agent == "prioritized"
  trainer = _jax_trainer(agent)
  conv = _converter(agent)
  jeng = trainer.engine
  dstate = trainer.init(jax.random.PRNGKey(11))
  host0 = jax.device_get(dstate)
  run = trainer.make_run(1)
  steps = [[] for _ in range(WORLD)]
  online = []
  for _ in range(SUPERSTEPS):
    host = jax.device_get(dstate)
    pre = []
    for r in range(WORLD):
      per = convert.device_slice(host.per_device, r)
      step = {"draws": _jax_draws(jeng, per, prioritized)}
      if prioritized:
        rep = convert.replay_from_jax(per.replay, 84, "cpu", True)
        step.update(value_tree=rep.value_tree,
                    max_seen_priority=rep.max_seen_priority)
      pre.append((step, _device_params(dstate.target_params, r)))
    dstate = run(dstate)
    host = jax.device_get(dstate)
    online.append(torch.from_numpy(_device_params(dstate.online_params, 0)))
    for r in range(WORLD):
      step, target_before = pre[r]
      s = convert.dist_state_from_jax(conv, host, r)
      per = convert.device_slice(host.per_device, r)
      ref = {f: getattr(s.replay, f) for f in (
          "stack_count", "action", "reward", "discount", "is_terminal",
          "row_t", "frames", "indicator_tree", "t")}
      ref.update(
          stack=s.stack.frames, env_frames=s.env_frames,
          game_state=s.env.game_state._asdict(),
          learn_steps=s.telemetry.learn_steps,
          last_loss=float(s.telemetry.last_loss),
          epsilon=float(jeng.exploration_epsilon(
              jnp.float32(per.env_frames))),
          beta=float(jeng.importance_sampling_exponent(
              jnp.float32(per.replay.t) * jeng.config.num_envs)),
          target_changed=not np.array_equal(
              _device_params(dstate.target_params, r), target_before))
      if prioritized:
        ref["value_tree"] = s.replay.value_tree[0]
      step["ref"] = ref
      steps[r].append(step)
  return trainer, host0, steps, torch.stack(online), dstate


def _save_states(workdir, conv, host, prefix: str = "init") -> None:
  for r in range(WORLD):
    torch.save(tckpt.flatten_state(convert.dist_state_from_jax(conv, host,
                                                               r)),
               os.path.join(workdir, f"{prefix}{r}.pt"))


@pytest.mark.parametrize("agent", ["dqn", "prioritized"])
def test_two_ranks_match_jax_shard_map(agent, tmp_path):
  """Two gloo ranks of the port against JAX's shard_map trainer on two CPU
  devices, superstep for superstep from one converted state and JAX's
  draws: replay rows, env state, frame counts, ε and β at m = 2 exact
  (frames within K2's ±1); loss rtol 1e-3; parameters within the slice
  test's bounds (max 5e-5, 99.9 % within 2e-6) of JAX's; each rank's target
  swapped where JAX's device swapped; the ranks' parameters bit for bit
  equal to each other."""
  _, host0, steps, online, _ = _jax_run(agent)
  assert steps[0][-1]["ref"]["learn_steps"] >= 5
  assert int(steps[0][-1]["ref"]["is_terminal"].sum()) > 2  # episodes ended
  assert any(s["ref"]["target_changed"] for s in steps[0])
  # The devices' streams differ: each rank's replay holds other frames.
  assert not torch.equal(steps[0][-1]["ref"]["frames"],
                         steps[1][-1]["ref"]["frames"])
  _write_config(tmp_path, agent)
  _save_states(tmp_path, _converter(agent), host0)
  for r in range(WORLD):
    torch.save(steps[r], tmp_path / f"steps{r}.pt")
  torch.save(online, tmp_path / "online.pt")
  run_ranks("match", tmp_path)


def test_distributed_eval_and_metrics_match_jax(tmp_path):
  """DistributedTrainer.metrics and eval_metrics on the converted states of
  JAX's trainer equal JAX's (sums over the ranks, the ε mean, the
  in-progress fallback after a telemetry reset)."""
  trainer, _, _, _, dstate = _jax_run("dqn")
  eval_envs = 2
  estate = trainer.eval_init(jax.random.PRNGKey(5), num_envs=eval_envs)
  estate = trainer.make_eval_run(12)(dstate.online_params, estate)
  want = dict(metrics=trainer.metrics(dstate),
              eval=trainer.eval_metrics(estate),
              reset=trainer.metrics(trainer.reset_telemetry(dstate)),
              eval_envs=eval_envs)
  assert want["metrics"]["episodes"] > 0 and want["eval"]["episodes"] > 0
  assert want["reset"]["episodes"] == 0
  conv = _converter("dqn")
  _save_states(tmp_path, conv, jax.device_get(dstate))
  host = jax.device_get(estate)
  for r in range(WORLD):
    e = convert.device_slice(host, r)
    gen = torch.Generator()
    state = EvalState(
        env=convert.env_state_from_jax(conv.engine, e.env, "cpu"),
        stack=convert.namedtuple_from_jax(FrameStackState, e.stack, "cpu"),
        generator=gen, env_frames=convert.tensor(e.env_frames, "cpu").long(),
        episode_return=convert.tensor(e.episode_return, "cpu"),
        completed_return_sum=convert.tensor(e.completed_return_sum, "cpu"),
        completed_count=convert.tensor(e.completed_count, "cpu"))
    torch.save(tckpt.flatten_state(state), tmp_path / f"eval{r}.pt")
  with open(tmp_path / "jax_metrics.json", "w") as f:
    json.dump(want, f)
  _write_config(tmp_path, "dqn")
  run_ranks("metrics", tmp_path)


def test_checkpoint_roundtrip_two_ranks(tmp_path):
  """Each rank saves and restores its own file (checks in the workers); a
  single-device restore of the two-rank slot is refused."""
  _write_config(tmp_path, "dqn")
  run_ranks("checkpoint", tmp_path)
  assert sorted(p.name for p in (tmp_path / "full").iterdir()) == [
      "meta.json", "state.1.rank0.pt", "state.1.rank1.pt"]
  with pytest.raises(ValueError, match="ranks' states"):
    tckpt.TorchCheckpoint(str(tmp_path / "lite")).restore(None)


@pytest.mark.parametrize("backend", ["gloo", "nccl"])
def test_rank_checkpoint_exchanges_on_the_groups_device(backend,
                                                       monkeypatch):
  """RankCheckpoint's device, with none asked for: the CPU under gloo, this
  rank's card under NCCL (which raises on this machine, having no card);
  a device asked for is kept under either backend."""
  import torch.distributed as dist
  monkeypatch.setattr(dist, "get_backend", lambda group=None: backend)
  if backend == "gloo":
    assert tckpt.exchange_device() == torch.device("cpu")
  else:
    with pytest.raises(RuntimeError, match="CUDA is not available"):
      tckpt.exchange_device()
  assert tckpt.exchange_device("cpu") == torch.device("cpu")


def test_learn_gate_reads_the_least_replay_size_over_ranks(tmp_path):
  """A rank whose replay passed the min fill does not learn while another's
  has not (the replay size counts active rows, which differ between ranks
  whose episodes end apart)."""
  _write_config(tmp_path, "dqn", overrides=dict(
      OVERRIDES, min_replay_capacity_fraction=0.25))
  run_ranks("gate", tmp_path)


@pytest.mark.parametrize("agent,num_envs,ranks,mode,batch", [
    ("dqn", 128, 2, "throughput", 0), ("dqn", 128, 4, "throughput", 0),
    ("dqn", 8, 4, "parity", 0), ("prioritized", 16, 2, "throughput", 64),
    ("iqn", 64, 8, "throughput", 0), ("rainbow", 4, 2, "parity", 0)])
def test_build_trainer_matches_jax(agent, num_envs, ranks, mode, batch):
  """run.train.build_config's per-rank EngineConfig (what
  train_dist.build_trainer builds its DistributedTrainer on) equals the one
  JAX's build_trainer gives its DistributedTrainer, field for field."""
  kw = dict(agent_name=agent, game="pong", replay_capacity=4096,
            batch_size=batch, replay_ratio_mode=mode, num_iterations=3,
            num_train_frames=1000)
  jcfg = jtrain_dist.build_trainer(
      num_devices=ranks, num_envs_global=num_envs,
      devices=jax.devices()[:ranks], **kw).engine.config
  tcfg = ttrain.build_config(num_envs=num_envs, num_ranks=ranks, **kw)
  for f in dataclasses.fields(tcfg):
    got, want = getattr(tcfg, f.name), getattr(jcfg, f.name)
    if f.name == "agent":
      assert got.learning_rate == want.learning_rate
      assert got.min_replay_capacity_fraction == \
          want.min_replay_capacity_fraction
    elif f.name == "env_config":
      assert got.episode_frame_cap == want.episode_frame_cap
    else:
      assert got == want, f.name
  with pytest.raises(ValueError, match="divide evenly"):
    ttrain.build_config(num_envs=num_envs, num_ranks=3, **kw)


@pytest.mark.parametrize("m", [2, 4])
def test_frame_multiplier_schedules_match_jax(m):
  """ε over env frames and β over inserted transitions at frame multiplier
  m against JAX's Engine; the target swaps every period // m frames of the
  rank's own count (JAX's rule, superstep.py's step 7; the two-rank test
  holds it against JAX's superstep at m = 2)."""
  common = dict(game="catch", num_envs=2, slots_per_stream=32,
                total_train_frames=40_000, frame_multiplier=m)
  spec = dict(target_network_update_period=100)
  jeng = JEngine(JEngineConfig(agent=dataclasses.replace(
      jget_agent("prioritized"), **spec), **common))
  teng = Engine(EngineConfig(agent=dataclasses.replace(
      get_agent("prioritized"), **spec), **common), device="cpu")
  for frames in (0, 1, 7, 12, 13, 95, 96, 97, 1000, 2559, 2561, 9999,
                 10_000, 40_000, 123_457):
    assert teng.exploration_epsilon(frames) == float(
        jeng.exploration_epsilon(jnp.float32(frames))), frames
  for t in (0, 1, 2, 3, 4, 5, 40, 100, 2500, 5000, 9999, 123_457):
    inserted = t * common["num_envs"]
    assert teng.importance_sampling_exponent(inserted) == float(
        jeng.importance_sampling_exponent(
            jnp.float32(t) * common["num_envs"])), t
  period = 100 // m
  for before in range(0, 120, 3):
    for after in (before + 1, before + 4, before + 9):
      target, online = {"w": torch.zeros(1)}, {"w": torch.ones(1)}
      teng.swap_target(target, online, before, after)
      assert bool(target["w"][0]) == (before // period != after // period)


def test_host_engine_swaps_at_the_frame_multiplier():
  """The host env engine's target swap (through Engine.swap_target) counts
  global frames: every period // 2 of the rank's own frames at m = 2."""
  period, m = 16, 2
  cfg = EngineConfig(
      agent=dataclasses.replace(get_agent("dqn"),
                                target_network_update_period=period,
                                min_replay_capacity_fraction=1.0),
      game="catch", num_envs=2, slots_per_stream=32, batch_size=4,
      frame_multiplier=m)
  env = CppVectorEnv("catch", 2, seed=0, num_threads=1, device="cpu")
  eng = HostEnvEngine(cfg, env, device="cpu")
  state = eng.init(0)
  group = env.step(np.zeros((2,), np.int32))
  swaps = 0
  for _ in range(12):
    with torch.no_grad():
      leaves(state.online_params)[0].add_(1.0)  # no learning: mark online
    before = state.env_frames
    state, actions = eng.step(state, group)
    group = env.step(actions)
    swapped = torch.equal(leaves(state.target_params)[0],
                          leaves(state.online_params)[0])
    assert swapped == (before // (period // m)
                       != state.env_frames // (period // m)), before
    swaps += swapped
  env.close()
  assert swaps >= 4


def test_cli_two_ranks_writes_reference_csv(tmp_path):
  """--mesh_devices=2 --device=cpu over two iterations, then a resume that
  runs the third: one CSV of the 14 columns, written by the first rank
  only, continued by the resume."""
  run_ranks("cli", tmp_path)
  assert not (tmp_path / "results1.csv").exists()
  lines = (tmp_path / "results0.csv").read_text().splitlines()
  header = lines[0].split(",")
  assert len(header) == 14 and header[-1] == "eval_frames"
  rows = [dict(zip(header, line.split(","))) for line in lines[1:]]
  assert [int(r["iteration"]) for r in rows] == [0, 1, 2]
  assert rows[0]["train_episode_return"] == "nan"
  assert all(int(r["eval_frames"]) > 0 for r in rows)
  meta = json.loads((tmp_path / "ckpt" / "meta.json").read_text())
  assert meta["world_size"] == 2 and meta["iteration"] == 3


def test_ranks_that_outnumber_the_cards_raise(monkeypatch):
  """init_distributed on the card (the default) with more ranks on the node
  than CUDA cards raises before joining any group: no quiet switch to gloo
  or to the CPU. (This machine has no card, so one rank is already one
  too many.)"""
  import torch.distributed as dist
  from dqn_zoo_torch.parallel import init_distributed
  monkeypatch.setenv("LOCAL_RANK", "0")
  monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
  monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
  monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
  with pytest.raises(RuntimeError, match="2 ranks on this node, 1 CUDA"):
    init_distributed()
  assert not dist.is_initialized()
