"""Where the card idles inside dqn_zoo_torch's superstep, and what the span
recorder (dqn_zoo_torch/utils/profiling.py) costs.

One benchmark cell's set-up and warm-up (benchmark/harness.py), then:
  1. a profiled stretch of the cell's `profiled_supersteps` (device
     activity only, as benchmark/trace.py's DeviceTrace profiles), read by
     every per-layer metric of BENCHMARK.json that lists the cell, with the
     card's idle time by the innermost host span (`idle_by_span`) and the
     check that the split adds up to the stretch's idle time;
  2. what that profile holds besides device events: every event name that
     is not device-typed, with its count, and the launches a superstep
     inside env.step and prep counted from the CUDA runtime's records;
  3. unprofiled stretches with the recorder off and on, in turns (off, on,
     on, off, ...): wall ms a superstep, ended by a synchronize;
  4. the host's cost of a no-op span, of a recorded span and of a count.
Prints one JSON line and writes it to --out.

  python3 tools/torch_spans_probe.py [--workload iqn.pong.e128]
      [--seed N] [--pairs 4] [--stretch 40] [--out chiprun_out/spans.json]
"""

import argparse
import bisect
import dataclasses
import json
import os
import pathlib
import statistics
import subprocess
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def _card() -> str:
  try:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30).stdout.strip()
  except (OSError, subprocess.TimeoutExpired) as e:
    return f"nvidia-smi: {e}"


def _span_costs(n=200_000) -> dict:
  from dqn_zoo_torch.utils import profiling
  rec = profiling.Recorder()

  def per(fn, k=n):
    t0 = time.perf_counter_ns()
    for _ in range(k):
      fn()
    return (time.perf_counter_ns() - t0) / k

  def with_span():
    with rec.span("x"):
      pass

  def pair():
    rec.span("x")
    rec.end()

  out = dict(noop_with_ns=per(with_span), noop_pair_ns=per(pair),
             noop_count_ns=per(lambda: rec.count("x")))
  with rec.recording():
    out.update(on_with_ns=per(with_span, 50_000),
               on_count_ns=per(lambda: rec.count("x"), 50_000))
  rec.drain()
  return out


def _quartiles(xs):
  xs = sorted(xs)
  if not xs:
    return None
  q = statistics.quantiles(xs, n=4) if len(xs) > 1 else [xs[0]] * 3
  return dict(n=len(xs), min=xs[0], q1=q[0], median=q[1], q3=q[2],
              max=xs[-1])


def _clock_check(st, kernel_at, launch_at, events, launch) -> dict:
  """How the clocks line up, in µs: each kernel's start after its launch
  record's (the same correlation id), both on the profiler's clock; each
  learn.sample span's start before the first launch record inside it and
  before K1's start (spans mapped by the recorder's anchors)."""
  lags = [(kernel_at[c] - launch_at[c]) / 1e3 for c in kernel_at
          if c in launch_at]
  firsts, k1 = [], []
  starts = sorted(a for _, a, _ in launch)
  k1_starts = sorted(a for n, a, _ in events if "gather_windows_kernel" in n)
  for s in st.named("learn.sample"):
    a, b = st.us(s.start_ns), st.us(s.end_ns)
    i = bisect.bisect_left(starts, a)
    if i < len(starts) and starts[i] <= b:
      firsts.append(starts[i] - a)
    j = bisect.bisect_left(k1_starts, a - 5e3)
    if j < len(k1_starts):
      k1.append(k1_starts[j] - a)
  return dict(kernel_after_launch_us=_quartiles(lags),
              first_launch_after_sample_open_us=_quartiles(firsts),
              k1_after_sample_open_us=_quartiles(k1))


def main(argv=None) -> int:
  from benchmark import run as bench_run
  bench_run.fixed_caches()
  p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  p.add_argument("--workload", default="iqn.pong.e128")
  p.add_argument("--seed", type=int, default=7_100_000_001)
  p.add_argument("--pairs", type=int, default=4)
  p.add_argument("--stretch", type=int, default=40)
  p.add_argument("--out", default="chiprun_out/spans.json")
  args = p.parse_args(argv)

  import torch
  from benchmark import harness, readers, spans, trace
  from dqn_zoo_torch import kernels
  from dqn_zoo_torch.utils import profiling
  torch.set_num_threads(1)
  out = dict(card=_card(), torch=torch.__version__, cuda=torch.version.cuda,
             workload=args.workload, seed=args.seed,
             span_costs=_span_costs())

  cell = harness.Cell.find(args.workload)
  r = harness.Run(cell, args.seed)
  state, _, _ = r.set_up()
  state = r.warm_up(state)
  n = cell.traffic["trace"]["profiled_supersteps"]

  # 1-2. One profiled stretch; its device events as DeviceTrace keeps them.
  before = kernels.counts()
  act = torch.profiler.ProfilerActivity
  prof = torch.profiler.profile(
      activities=[act.CUDA if r.dev.type == "cuda" else act.CPU])
  prof.start()
  r.sync()
  t0 = time.perf_counter()
  for _ in range(n):
    state = r.engine.superstep(state)
  r.sync()
  wall = time.perf_counter() - t0
  prof.stop()
  launched = {k: v - before[k] for k, v in kernels.counts().items()}
  drained = profiling.drain()
  cuda = torch.autograd.DeviceType.CUDA
  events, others, launch = [], {}, []
  kernel_at, launch_at = {}, {}  # correlation id -> start ns
  for e in prof.profiler.kineto_results.events():
    start = e.start_ns() / 1e3
    if e.device_type() == cuda and e.duration_ns() > 0:
      events.append((e.name(), start, start + e.duration_ns() / 1e3))
      kernel_at[e.correlation_id()] = e.start_ns()
    else:
      key = f"{e.name()} [{e.device_type()}]"
      others[key] = others.get(key, 0) + 1
      if e.name() in spans.LAUNCHES:
        launch.append((e.name(), start, start + e.duration_ns() / 1e3))
        launch_at[e.correlation_id()] = e.start_ns()
  ctx = readers.Context(
      cell=cell, family=cell.config["reference"], streams=r.streams,
      batch=r.batch, num_actions=r.num_actions, flags=r.flags,
      events=events, window_s=wall, launched=launched, supersteps=n,
      stage_ms={}, window_times=[], reset_flags=[])
  st = spans.hold(ctx, drained)
  metrics = {m["name"]: readers.load(m["name"]).read(ctx)
             for m in cell.per_layer}
  by, idle_s = spans.idle(ctx) or ({}, None)
  out.update(
      stretch=dict(supersteps=n, wall_s=wall, spans=len(st.spans),
                   spans_per_superstep=len(st.spans) / n,
                   dropped=drained.dropped, counters=drained.counters,
                   anchors=[list(a) for a in drained.anchors],
                   busy_s=trace.busy_seconds(events), idle_s=idle_s,
                   idle_split_sum_s=sum(by.values()),
                   resets=len(st.named("env.reset_burn"))),
      metrics=metrics, idle_by_span=spans.idle_by_span(ctx, top=10),
      idle_by_every_span={str(k): v for k, v in by.items()},
      self_ms={name: st.per_superstep_ms(st.self_seconds(name))
               for name in sorted({s.name for s in st.spans})},
      non_device_events=dict(sorted(others.items(), key=lambda kv: -kv[1])
                             [:40]))
  ctx_l = dataclasses.replace(ctx, events=launch)
  spans.hold(ctx_l, drained)
  out["launches_from_runtime_records"] = dict(
      env_and_prep=spans.launches(ctx_l),
      learn=spans.launches(ctx_l, ("learn",)),
      superstep=spans.launches(ctx_l, ("superstep",)),
      records=len(launch))

  out["clock"] = _clock_check(st, kernel_at, launch_at, events, launch)

  # 3. Unprofiled stretches, the recorder off and on in turns.
  walls = {"off": [], "on": []}
  for i in range(args.pairs):
    for side in (("off", "on") if i % 2 == 0 else ("on", "off")):
      r.sync()
      t0 = time.perf_counter()
      if side == "on":
        with profiling.recording():
          for _ in range(args.stretch):
            state = r.engine.superstep(state)
          r.sync()
      else:
        for _ in range(args.stretch):
          state = r.engine.superstep(state)
        r.sync()
      walls[side].append(1e3 * (time.perf_counter() - t0) / args.stretch)
      profiling.drain()
  out["recorder_cost"] = dict(
      ms_a_superstep=walls,
      median_off=statistics.median(walls["off"]),
      median_on=statistics.median(walls["on"]))
  line = json.dumps(out)
  os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
  with open(args.out, "w") as f:
    f.write(line + "\n")
  print(line)
  return 0


if __name__ == "__main__":
  sys.exit(main())
