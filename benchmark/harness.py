"""One run of one cell: set-up, the timed window, the traced stretches and
the comparison that decides `correct`.

The system under test is `dqn_zoo_torch`'s throughput-mode trainer: the
engine that `dqn_zoo_torch.run.train.build_engine` builds from the
configuration's flags, looped through `Engine.superstep` as the CLI's train
phase loops it. Set-up puts it at the steady state of a long run:
  1. weights made on the device from the seed (the reference's initializer)
     and copied into the engine's online and target parameters;
  2. episodes at spread phases: one env step resets every stream, the
     traffic's phase field (pong: the opponent's score) takes a value a
     stream from a fixed multiset in the seed's order, and env-only steps
     under random actions follow (no act, no insert, no learning);
  3. the replay filled to capacity through `replay_insert` with the
     traffic's rows, the insert counter and the frame counter at the
     traffic's steady-state point;
  4. three learning supersteps through `Engine.superstep`, their draws,
     the env's output, the actions, the sampled leaves and the parameters
     kept for the reference, then warm-up supersteps (one with a reset).
The window then loops `Engine.superstep` for `seconds`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import statistics
import sys
import time
from typing import Dict, List, Optional

import torch

from benchmark import check, readers, trace, traffic as tr
from benchmark.reference import common as ref_common
from benchmark.reference.follow import follow

BENCHMARK_JSON = tr.ROOT.parent / "BENCHMARK.json"
FORBIDDEN = ("jax", "jaxlib", "flax", "dqn_zoo_tpu")


class RunError(RuntimeError):
  """A run that cannot give a result (no card, a bad name, JAX loaded)."""


def load_benchmark() -> dict:
  return json.loads(BENCHMARK_JSON.read_text())


@dataclasses.dataclass
class Cell:
  name: str
  entry: dict
  config: dict
  traffic: dict
  workload: dict
  per_layer: List[dict]

  @classmethod
  def find(cls, name: str, bench: Optional[dict] = None) -> "Cell":
    bench = bench or load_benchmark()
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
      raise RunError(f"unknown workload {name!r}; have {sorted(entries)}")
    e = entries[name]
    per_layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", entries)]
    return cls(name, e, tr.load("configs", e["config"]),
               tr.load("traffic", e["traffic"]), tr.load("workloads", name),
               per_layer)


# dqn_zoo's flag names where the agent's spec names the field otherwise.
_FLAG_FIELD = {
    "exploration_epsilon_begin_value": "exploration_epsilon_begin",
    "exploration_epsilon_end_value": "exploration_epsilon_end",
    "n_steps": "n_step",
    "importance_sampling_exponent_begin_value": "importance_sampling_begin",
    "importance_sampling_exponent_end_value": "importance_sampling_end",
}


def spec_overrides(config: dict) -> dict:
  """The agent spec's fields that the configuration's flags set, and its
  compute dtype; a flag the spec has no field for is an error."""
  from dqn_zoo_torch.agents.base import AgentSpec
  fields = {f.name for f in dataclasses.fields(AgentSpec)}
  out = {"compute_dtype": config["compute_dtype"]}
  for k, v in config["flags"].items():
    f = _FLAG_FIELD.get(k, k)
    if f not in fields:
      raise RunError(f"flag {k!r} of {config['name']} sets nothing")
    out[f] = v
  return out


def forbidden_modules() -> List[str]:
  return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _outputs(out) -> dict:
  keep = ("frame_penult", "frame_last", "reward_sum", "discount_prod",
          "is_first", "is_last")
  return {k: getattr(out, k).clone() for k in keep}


def _plain_draws(d) -> dict:
  """A SuperstepDraws as plain tensors, the first update's where the draws
  carry an updates axis."""
  noise = lambda n: {k: v.clone() for k, v in n._asdict().items()}
  out = dict(explore_u=d.explore_u.clone(),
             random_action=d.random_action.clone(),
             sample_u=d.sample_u[0].clone())
  if d.act_taus is not None:
    out["act_taus"] = d.act_taus.clone()
  if d.loss_taus is not None:
    out["loss_taus"] = tuple(t[0].clone() for t in d.loss_taus)
  if d.act_noise is not None:
    out["act_noise"] = noise(d.act_noise)
  if d.loss_noise is not None:
    out["loss_noise"] = tuple(
        {k: v[0].clone() for k, v in n._asdict().items()}
        for n in d.loss_noise)
  return out


@contextlib.contextmanager
def _patched(obj, name, wrapper):
  """obj.name replaced by wrapper(original) inside the block."""
  orig = getattr(obj, name)
  had = name in vars(obj) if hasattr(obj, "__dict__") else False
  setattr(obj, name, wrapper(orig))
  try:
    yield
  finally:
    if had:
      setattr(obj, name, orig)
    else:
      delattr(obj, name)


class Run:
  """One run of one cell on `device` (the card unless a test asks for the
  CPU)."""

  def __init__(self, cell: Cell, seed: int, device=None):
    from dqn_zoo_torch.run.train import build_engine
    self.cell, self.seed = cell, seed
    t, c = cell.traffic, cell.config
    self.flags = c["flags"]
    self.engine = build_engine(
        c["agent"], t["game"], t["num_envs"], t["replay_capacity"],
        t.get("batch_size", 0), "throughput",
        num_iterations=t["num_iterations"],
        num_train_frames=t["num_train_frames"],
        spec_overrides=spec_overrides(c), device=device)
    self.dev = self.engine.device
    ec = self.engine.config
    self.streams, self.slots, self.batch = (ec.num_envs, ec.slots_per_stream,
                                            ec.batch_size)
    if ec.updates_per_learn != 1 or ec.learn_every != 1:
      raise RunError("a cell learns once a superstep (throughput mode)")
    self.num_actions = self.engine.num_actions

  # --- set-up -----------------------------------------------------------------

  def weights(self, state):
    """The benchmark's weights, copied into the engine's online and target
    parameters; returns them (the reference's copy)."""
    from benchmark.reference.follow import family
    gen = tr.device_generator(self.seed, 6, self.dev)
    mine = family(self.cell.config["reference"]).init_params(
        gen, self.dev, self.num_actions, self.flags)
    theirs_on = ref_common.flat(state.online_params)
    theirs_tg = ref_common.flat(state.target_params)
    ours = ref_common.flat(mine)
    if set(ours) != set(theirs_on):
      raise RunError(f"parameter layout differs: {sorted(ours)} against "
                     f"{sorted(theirs_on)}")
    with torch.no_grad():
      for k, v in ours.items():
        theirs_on[k].copy_(v)
        theirs_tg[k].copy_(v)
    return mine

  def spread(self, state):
    """Episodes at spread phases; returns the state, with the pending row
    and the stack of the last step, and that step's and the three before
    its env outputs."""
    from dqn_zoo_torch import prep
    from dqn_zoo_torch.engine.superstep import PendingRow
    sp = self.cell.traffic["spread"]
    env, dev = self.engine.env, self.dev
    gen = tr.device_generator(self.seed, 5, dev)
    est, stack = state.env, state.stack
    kept = []
    for i in range(sp["steps"] + 1):
      actions = torch.randint(0, self.num_actions, (self.streams,),
                              generator=gen, device=dev)
      est, out = env.step(est, actions, env.draws(gen))
      if i == 0:
        gs = est.game_state
        field = getattr(gs, sp["field"])
        values = tr.spread_values(self.seed, sp, self.streams, dev)
        est = est._replace(game_state=gs._replace(
            **{sp["field"]: values.to(field.dtype)}))
      obs = prep.pooled_frame_to_84(out.frame_penult, out.frame_last,
                                    self.engine.config.resize_method)
      stack = prep.frame_stack_update(stack, obs, out.is_first)
      kept = (kept + [_outputs(out)])[-4:]
    zero = torch.zeros_like(out.reward_sum)
    pending = PendingRow(
        frame=obs, stack_count=stack.count,
        reward=torch.where(out.is_first, zero,
                           torch.clamp(out.reward_sum, -1.0, 1.0)),
        discount=torch.where(out.is_first, zero, out.discount_prod * 0.99),
        is_terminal=out.is_last)
    return state._replace(env=est, stack=stack, pending=pending), kept

  def fill(self, state):
    from dqn_zoo_torch.replay import device_replay as dr
    t = self.cell.traffic
    n = tr.fill_inserts(t, self.streams)
    rows = tr.FillRows(self.seed, t, self.num_actions)
    replay, rcfg = state.replay, self.engine.rcfg
    streams = torch.arange(self.streams, device=self.dev)
    block = 64
    for t0 in range(0, n, block):
      steps = torch.arange(t0, min(t0 + block, n), device=self.dev)
      r = rows.rows(streams[None, :].expand(len(steps), -1),
                    steps[:, None].expand(-1, self.streams))
      for i in range(len(steps)):
        replay = dr.replay_insert(rcfg, replay, r.frame[i], r.stack_count[i],
                                  r.action[i], r.reward[i], r.discount[i],
                                  r.is_terminal[i])
    return state._replace(replay=replay,
                          env_frames=int(t["steady_state_frames"])), n

  def checked_steps(self, state, params0, spread_outputs, inserted):
    """Three learning supersteps through `Engine.superstep` with the draws
    it would make itself, the stages' outputs kept; returns the state and
    the reference's handover, and the program's outputs to judge."""
    from dqn_zoo_torch.replay import device_replay as dr
    eng = self.engine
    period = eng.spec.target_network_update_period
    f0 = state.env_frames
    if f0 // period != (f0 + 3 * 4 * self.streams) // period:
      raise RunError("a target swap would fall inside the checked steps")
    got = dict(outputs=[], actions=[], stacks=[], samples=[], prios=[])

    def env_step(orig):
      def f(est, actions, draws):
        est, out = orig(est, actions, draws)
        got["outputs"].append(_outputs(out))
        return est, out
      return f

    def act(orig):
      def f(params, obs, epsilon, draws):
        actions, values = orig(params, obs, epsilon, draws)
        got["stacks"].append(obs.clone())
        got["actions"].append(actions.clone())
        return actions, values
      return f

    def sample(orig):
      def f(*args, **kw):
        batch, leaves, weights = orig(*args, **kw)
        got["samples"].append((leaves.clone(), batch))
        return batch, leaves, weights
      return f

    def prios(orig):
      def f(cfg, replay, leaves, priorities):
        got["prios"].append(priorities.clone())
        return orig(cfg, replay, leaves, priorities)
      return f

    draws, losses = [], []
    with _patched(eng.env, "step", env_step), _patched(eng, "_act", act), \
        _patched(dr, "replay_sample", sample), \
        _patched(dr, "replay_update_priorities", prios):
      for j in range(3):
        d = eng.draw(state.generator)
        draws.append(_plain_draws(d))
        state = eng.superstep(state, draws=d)
        losses.append(float(state.telemetry.last_loss))
        if j == 0:
          b1 = eng.optimizer.inner.b1 if hasattr(eng.optimizer, "inner") \
              else eng.optimizer.b1
          mu = state.opt_state.mu
          grad1 = self._by_path(state, [m / (1.0 - b1) for m in mu])
    params3 = {k: v.detach().clone()
               for k, v in ref_common.flat(state.online_params).items()}
    handover = dict(
        reference=self.cell.config["reference"], flags=self.flags,
        traffic=self.cell.traffic, seed=self.seed,
        num_actions=self.num_actions, num_envs=self.streams,
        slots=self.slots, batch_size=self.batch, inserted=inserted,
        env_frames=f0, params0=params0,
        outputs=spread_outputs + got["outputs"][:2], draws=draws,
        actions=got["actions"], leaves=[s[0] for s in got["samples"]])
    prog = dict(losses=losses, grad1=grad1, params3=params3,
                actions=got["actions"], stacks=got["stacks"],
                batches=[s[1] for s in got["samples"]],
                priorities=got["prios"])
    return state, handover, prog

  def _by_path(self, state, per_leaf):
    from dqn_zoo_torch.utils.pytree import leaves
    ids = {id(t): k for k, t in ref_common.flat(state.online_params).items()}
    return {ids[id(t)]: v.detach().clone()
            for t, v in zip(leaves(state.online_params), per_leaf)}

  def set_up(self):
    """Steps 1-4 of the module docstring but the warm-up; returns the
    state, the reference's handover and the program's outputs to judge.
    `phases` gets each step's seconds."""
    self.phases: Dict[str, float] = {}
    self.t_mark = time.perf_counter()

    def lap(name):
      self.sync()
      now = time.perf_counter()
      self.phases[name] = now - self.t_mark
      self.t_mark = now

    state = self.engine.init(tr.key(self.seed, 7))
    params0 = self.weights(state)
    lap("init")
    state, kept = self.spread(state)
    lap("spread")
    state, inserted = self.fill(state)
    lap("fill")
    state, handover, prog = self.checked_steps(state, params0, kept,
                                               inserted)
    lap("checked_steps")
    return state, handover, prog

  def warm_up(self, state):
    """Supersteps until at least `min_supersteps` and one that took the
    reset branch, so that every shape and path the window runs is warm."""
    w = self.cell.traffic["warmup"]
    resets = 0
    for i in range(w["max_supersteps"]):
      resets += bool(state.env.needs_reset.any())
      state = self.engine.superstep(state)
      if i + 1 >= w["min_supersteps"] and resets:
        break
    self.sync()
    return state

  def sync(self):
    if self.dev.type == "cuda":
      torch.cuda.synchronize(self.dev)

  # --- measured stretches ------------------------------------------------------

  def window(self, state, seconds: float, flags: Optional[list] = None):
    """Supersteps for `seconds`; returns (state, frames, wall seconds,
    per-superstep host seconds). `flags`, when given, gets each
    superstep's needs-reset flag, kept on the device."""
    sup = self.engine.superstep
    times = []
    f0 = state.env_frames
    t0 = time.perf_counter()
    while True:
      if flags is not None:
        flags.append(state.env.needs_reset.any())
      a = time.perf_counter()
      state = sup(state)
      b = time.perf_counter()
      times.append(b - a)
      if b - t0 >= seconds:
        break
    self.sync()
    return state, state.env_frames - f0, time.perf_counter() - t0, times

  def fenced(self, state, n: int):
    timings: Dict[str, float] = {}
    for _ in range(n):
      state = self.engine.superstep(state, timings=timings)
    return state, {k: 1e3 * v / n for k, v in timings.items()}

  def profiled(self, state, n: int):
    """n supersteps under torch.profiler (device activity only, so that the
    host's pace is not the profiler's); returns the state, the device
    events, the wall seconds and the kernels' launches."""
    from dqn_zoo_torch import kernels
    before = kernels.counts()
    with trace.DeviceTrace(self.dev) as t:
      self.sync()
      t0 = time.perf_counter()
      for _ in range(n):
        state = self.engine.superstep(state)
      self.sync()
      wall = time.perf_counter() - t0
    launched = {k: v - before[k] for k, v in kernels.counts().items()}
    return state, t.events(), wall, launched


def _p95(times: List[float]) -> float:
  if len(times) < 2:
    return max(times)
  return statistics.quantiles(times, n=100, method="inclusive")[94]


def run(name: str, seed: int, seconds: float, traced: bool,
        t_start: float) -> dict:
  """One run on the card; returns the result line's object."""
  return run_cell(Cell.find(name), seed, seconds, traced, t_start)


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool,
             t_start: float, device=None) -> dict:
  """One run of `cell`. `device` None takes the card and fails without
  one; the CPU tests pass "cpu"."""
  name = cell.name
  if device is None:
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
      raise RunError(f"{name} needs {chips} CUDA device(s); this machine "
                     f"has {torch.cuda.device_count()}")
  r = Run(cell, seed, device)
  state, handover, prog = r.set_up()
  state = r.warm_up(state)
  setup_s = time.perf_counter() - t_start
  r.phases["warm_up"] = time.perf_counter() - r.t_mark
  print("setup " + json.dumps(r.phases), file=sys.stderr, flush=True)

  reset_flags = [] if traced else None
  state, frames, wall, times = r.window(state, seconds, reset_flags)
  if forbidden_modules():
    raise RunError(f"loaded after the window: {forbidden_modules()}")
  result = dict(correct=None, attempted=len(times), failed=0, metrics={},
                device=device_info(r.dev, int(cell.entry["chips"])))
  if traced:
    ts = cell.traffic["trace"]
    state, events, tw, launched = r.profiled(state, ts["profiled_supersteps"])
    state, stage_ms = r.fenced(state, ts["fenced_supersteps"])
    ctx = readers.Context(
        cell=cell, family=cell.config["reference"], streams=r.streams,
        batch=r.batch, num_actions=r.num_actions, flags=r.flags,
        events=events, window_s=tw, launched=launched,
        supersteps=ts["profiled_supersteps"], stage_ms=stage_ms,
        window_times=times,
        reset_flags=[bool(f) for f in reset_flags])
    result["metrics"] = readers.read_all(cell.per_layer, ctx)
    busy = trace.busy_seconds(events)
    result["device"].update(busy_s=busy, window_s=tw)
    result["breakdown"] = trace.breakdown(events)
  else:
    result["metrics"] = {
        "train_frames_per_s": dict(value=frames / wall, unit="frames/s"),
        "superstep_ms.p95": dict(value=1e3 * _p95(times), unit="ms"),
        "setup_s": dict(value=setup_s, unit="s")}
  if not math.isfinite(float(state.telemetry.last_loss)):
    result["failed"] = len(times)
  if r.dev.type == "cuda":
    result["device"]["memory_peak_bytes"] = torch.cuda.max_memory_allocated(
        r.dev)
  del state, r
  if device is None:
    torch.cuda.empty_cache()

  ref = follow(handover)
  prioritized = cell.config["flags"].get("priority_exponent", 0.0) > 0
  nums = check.numbers(prog, ref, handover["draws"], prioritized)
  limits = cell.workload["limits"]
  result["correct"] = check.verdict(nums, limits)
  result["checks"] = {k: dict(value=nums[k], limit=limits[k]) for k in nums}
  return result


def device_info(dev, chips: int) -> dict:
  if dev.type != "cuda":
    return dict(platform="cpu", kind="cpu", count=1, memory_peak_bytes=0)
  return dict(platform="gpu", kind=torch.cuda.get_device_name(dev),
              count=chips, memory_peak_bytes=0)
