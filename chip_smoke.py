"""Chip smoke test of the PyTorch/CUDA port (dqn_zoo_torch) on one card.

  python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and carried on):
  1. build every CUDA kernel from dqn_zoo_torch/csrc (one nvcc per source,
     all in parallel) and print the build time;
  2. hold each kernel against its plain PyTorch version at the main path's
     shapes, and time kernel, plain version, library call and bound;
  3. drive the main path — build_engine("dqn", "pong", num_envs=128,
     replay_capacity=1e6) in throughput mode (batch 1024) — through enough
     supersteps for >= 20 learn steps (a timed window of 600, which holds
     episode resets), then one eval chunk; check the loss,
     the outputs and that every kernel's launch counter moved;
  4. print the kernels line, the card's name and power limit, and last the
     result line {"ok": true, "device": {...}}.
Needs a CUDA card; imports nothing of JAX or of dqn_zoo_tpu.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import torch

# Published peaks of one H100 SXM at its 700 W limit (dense, no sparsity):
# HBM3 bandwidth and float32 outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# Input sets a memory-bound kernel's timing rotates through (see time_ms).
ROTATE = 8

TPU_KERNELS = {
    "gather_windows": "dqn_zoo_tpu/replay/window_gather.py:78",
    "pooled_frame_to_84": "dqn_zoo_tpu/prep/pallas_prep.py:63",
    "dqn_torso_fwd": "dqn_zoo_tpu/nets/torso_pallas.py:159",
    "dqn_torso_fwd_residuals": "dqn_zoo_tpu/nets/torso_pallas.py:112",
}
SOURCES = {
    "gather_windows": "dqn_zoo_torch/csrc/window_gather.cu",
    "pooled_frame_to_84": "dqn_zoo_torch/csrc/pooled_frame_to_84.cu",
    "dqn_torso_fwd": "dqn_zoo_torch/csrc/dqn_torso.cu",
    "dqn_torso_fwd_residuals": "dqn_zoo_torch/csrc/dqn_torso.cu",
}


def fail(msg: str):
  raise SystemExit(f"chip_smoke FAILED: {msg}")


def time_ms(fn, sets=((),), iters: int = 20, warmup: int = 3) -> float:
  """Mean device milliseconds per call, by CUDA events around `iters` calls.

  The calls rotate through the argument tuples in `sets`. A memory-bound
  kernel is given sets whose bytes together exceed the card's 50 MB L2, so
  that each call reads its inputs from HBM, as on the main path, and not
  from what the previous call left in L2."""
  n = len(sets)
  for i in range(warmup):
    fn(*sets[i % n])
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for i in range(iters):
    fn(*sets[i % n])
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float):
  t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
  t_ops = flops / PEAK_F32_FLOPS * 1e3
  return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(dev):
  """Each kernel against its plain version at the main path's shapes."""
  from dqn_zoo_torch.nets import torso_cuda
  from dqn_zoo_torch.nets.core import hwio_to_oihw
  from dqn_zoo_torch.prep import atari as tprep
  from dqn_zoo_torch.prep import cuda_prep
  from dqn_zoo_torch.replay import window_gather as twg

  gen = torch.Generator(device=dev)
  gen.manual_seed(0)
  results = {}

  def report(name, shape, err, tol, ms, plain_ms, library_ms, nbytes, flops,
             **extra):
    b_ms, b_by = bound(nbytes, flops)
    line = dict(name=name, shape=shape, max_abs_err=err, tolerance=tol,
                ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=b_ms, bound_by=b_by, **extra)
    print("KERNEL_CHECK " + json.dumps(line), flush=True)
    return line

  # K1: B = 1024 windows of W = 5 rows from 128 streams. Exact. Timing
  # rotates through 8 index sets, 289 MB of rows from a 1.85 GB store.
  b, w, s, r = 1024, 5, 128, 2048
  frames = torch.randint(0, 256, (s, r, 84, 84), generator=gen, device=dev,
                         dtype=torch.uint8)
  flat = frames.view(s * r, 84 * 84)
  sets = []
  for _ in range(ROTATE):
    stream = torch.randint(0, s, (b,), generator=gen, device=dev)
    start = torch.randint(0, r - w + 1, (b,), generator=gen, device=dev)
    rows = (stream[:, None] * r + start[:, None]
            + torch.arange(w, device=dev)).reshape(-1)
    sets.append((stream, start, rows))
  for stream, start, _ in sets:
    got = twg.gather_windows(frames, stream, start, w)
    want = twg.gather_windows_plain(frames, stream, start, w)
    if not torch.equal(got, want):
      fail("K1 gather_windows differs from its plain version")
  results["gather_windows"] = report(
      "gather_windows", f"B={b} W={w}", 0.0, "exact",
      time_ms(lambda st, sa, _: twg.gather_windows(frames, st, sa, w), sets),
      time_ms(lambda st, sa, _: twg.gather_windows_plain(frames, st, sa, w),
              sets),
      time_ms(lambda _, __, rw: torch.index_select(flat, 0, rw), sets),
      2 * b * w * 84 * 84 + 8 * b, 0)
  del frames, flat, sets

  # K2: B = 128 env frame pairs, 8 sets (206 MB) for the timing; one
  # penultimate frame of each set all zero.
  b = 128
  sets = []
  for _ in range(ROTATE):
    f1 = torch.randint(0, 256, (b, 210, 160, 3), generator=gen, device=dev,
                       dtype=torch.uint8)
    f2 = torch.randint(0, 256, (b, 210, 160, 3), generator=gen, device=dev,
                       dtype=torch.uint8)
    f1[0] = 0
    sets.append((f1, f2))
  got = torch.cat([cuda_prep.pooled_frame_to_84(*fs) for fs in sets])
  want = torch.cat([tprep.pooled_frame_to_84_plain(*fs) for fs in sets])
  diff = (got.int() - want.int()).abs()
  exact = float((diff == 0).float().mean())
  if int(diff.max()) > 1 or exact < 0.98:
    fail(f"K2 differs from its plain version: max {int(diff.max())}, "
         f"exact share {exact}")
  nbytes, flops = cuda_prep.bound_counts(b)
  results["pooled_frame_to_84"] = report(
      "pooled_frame_to_84", f"B={b}", float(diff.max()),
      "|diff| <= 1 and >= 98% exact",
      time_ms(cuda_prep.pooled_frame_to_84, sets),
      time_ms(tprep.pooled_frame_to_84_plain, sets), None,
      nbytes, flops, exact_share=exact)
  del sets

  # K3: torso weights at the legacy init scale.
  ws = []
  for name, shape in torso_cuda.SHAPES.items():
    fan_in = math.prod(shape[:-1]) if name.startswith("w") else 256
    u = torch.rand(shape, generator=gen, device=dev) * 2 - 1
    ws.append(u / math.sqrt(fan_in))
  w_oihw = [hwio_to_oihw(x).contiguous() for x in ws[0::2]]

  def library(xn):  # three cuDNN convolutions on prepared NCHW input
    h = xn
    for wt, bias, st in zip(w_oihw, ws[1::2], (4, 2, 1)):
      h = torch.relu(torch.nn.functional.conv2d(h, wt, bias, stride=st))
    return h

  # K3a at B = 128 (act) and B = 1024 (target). f32 both sides, TF32 off:
  # the sums differ only in order, so rtol 1e-4 holds with room.
  for b in (128, 1024):
    x = torch.randint(0, 256, (b, 84, 84, 4), generator=gen, device=dev,
                      dtype=torch.uint8)
    with torch.no_grad():
      got = torso_cuda.dqn_torso(*ws, x)
      want = torso_cuda.torso_plain(*ws, x)
      torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
      xn = x.permute(0, 3, 1, 2).float().mul(1.0 / 255.0).contiguous()
      nbytes, flops = torso_cuda.bound_counts(b, residuals=False)
      line = report(
          "dqn_torso_fwd", f"B={b}", float((got - want).abs().max()),
          "rtol 1e-4, atol 1e-5",
          time_ms(lambda: torso_cuda.torso_forward(ws, x, residuals=False)),
          time_ms(lambda: torso_cuda.torso_plain(*ws, x)),
          time_ms(lambda: library(xn)), nbytes, flops)
    if b == 1024:
      results["dqn_torso_fwd"] = line

  # K3b at B = 1024 (the online net under grad), and the gradients through
  # its autograd Function. Where a pre-activation lies within f32 rounding
  # of 0, the kernel and the plain forward may take different ReLU branches
  # (a few of the 17 M activations at this size), and each such flip moves
  # a weight gradient by a whole term. So the reference for the gradients
  # is autograd of the plain convolutions with the kernel's own ReLU masks:
  # it checks the backward independently of those flips, and must agree to
  # a relative Frobenius error of 1e-4. The flips are counted and printed.
  got, z1, z2 = torso_cuda.torso_forward(ws, x, residuals=True)
  want, wz1, wz2 = torso_cuda.torso_plain_residuals(*ws, x)
  for a, e in ((got, want), (z1, wz1), (z2, wz2)):
    torch.testing.assert_close(a, e, rtol=1e-4, atol=1e-5)
  flips = sum(int(((a > 0) != (e > 0)).sum())
              for a, e in ((got, want), (z1, wz1), (z2, wz2)))
  masks = [(t > 0).float() for t in (z1, z2, got.reshape(-1, 7, 7, 64))]

  dy = torch.randn((1024, 3136), generator=gen, device=dev)
  pa = [t.clone().requires_grad_(True) for t in ws]
  pb = [t.clone().requires_grad_(True) for t in ws]
  ga = torch.autograd.grad((torso_cuda.dqn_torso(*pa, x) * dy).sum(), pa)
  gb = torch.autograd.grad(
      (torso_cuda.torso_plain_masked(*pb, x, masks) * dy).sum(), pb)
  grad_err = max(
      float(torch.linalg.vector_norm(a - e) / torch.linalg.vector_norm(e))
      for a, e in zip(ga, gb))
  print(f"K3b gradients: relative Frobenius error {grad_err:.3e} "
        f"(ReLU branch flips against the plain forward: {flips})",
        flush=True)
  if not grad_err <= 1e-4:
    fail(f"K3b gradients differ from the plain version's: {grad_err}")
  nbytes, flops = torso_cuda.bound_counts(1024, residuals=True)
  with torch.no_grad():
    results["dqn_torso_fwd_residuals"] = report(
        "dqn_torso_fwd_residuals", "B=1024",
        float((got - want).abs().max()), "rtol 1e-4, atol 1e-5; grads relative Frobenius <= 1e-4",
        time_ms(lambda: torso_cuda.torso_forward(ws, x, residuals=True)),
        time_ms(lambda: torso_cuda.torso_plain_residuals(*ws, x)),
        time_ms(lambda: library(xn)), nbytes, flops,
        grad_rel_frobenius_err=grad_err)
  return results


def phase_main_path(dev):
  """The port's dqn/pong trainer at full width, through the user's entry
  points; returns the launch counts."""
  from dqn_zoo_torch import kernels
  from dqn_zoo_torch.run.train import build_engine

  engine = build_engine("dqn", "pong", num_envs=128,
                        replay_capacity=1_000_000,
                        min_replay_capacity_fraction=0.002, device="cuda")
  cfg = engine.config
  if (cfg.batch_size, cfg.learn_every, cfg.updates_per_learn) != (1024, 1, 1):
    fail(f"unexpected throughput-mode schedule {cfg}")
  state = engine.init(seed=1)
  torch.cuda.synchronize()
  print(f"MAIN engine built: replay {cfg.num_envs}x{cfg.slots_per_stream} "
        f"rows, frame store {state.replay.frames.numel() / 1e9:.2f} GB",
        flush=True)

  kernels.reset_counts()
  t0 = time.perf_counter()
  warm = 20  # the learn gate opens at ~2000 active rows (superstep ~18)
  state = engine.run(state, warm)
  torch.cuda.synchronize()
  t_warm = time.perf_counter() - t0
  # The timed window is long enough for pong's first episodes to end
  # (a near-random policy ends one in ~300-450 agent steps), so it holds
  # supersteps that run the env's reset branch (the noop burn over all
  # envs). Each superstep is timed on the host; whether it reset is kept
  # on the card and read after the window, so the loop adds no wait.
  timed = 600
  steps_before = state.telemetry.learn_steps
  episodes_before = float(state.telemetry.completed_count)
  counts_before = kernels.counts()
  resets, host_s = [], []
  t0 = time.perf_counter()
  for _ in range(timed):
    resets.append(state.env.needs_reset.any())
    t1 = time.perf_counter()
    state = engine.superstep(state)
    host_s.append(time.perf_counter() - t1)
  torch.cuda.synchronize()
  t_run = time.perf_counter() - t0
  step_s = {True: [], False: []}
  for reset, sec in zip(torch.stack(resets).tolist(), host_s):
    step_s[reset].append(sec)
  learned_in_timed = state.telemetry.learn_steps - steps_before
  if learned_in_timed != timed * cfg.updates_per_learn:
    fail(f"{learned_in_timed} learn steps in {timed} timed supersteps")
  counts_after = kernels.counts()
  per_learning_superstep = {
      k: (counts_after[k] - counts_before[k]) / timed for k in counts_after}
  episodes_in_timed = float(state.telemetry.completed_count) - episodes_before
  split = {}
  fenced = 100
  state = engine.run(state, fenced, timings=split)
  torch.cuda.synchronize()
  train_counts = kernels.counts()
  estate = engine.eval_init(seed=2, num_envs=4)
  estate = engine.eval_run(state.online_params, estate, 100)
  torch.cuda.synchronize()
  counts = kernels.counts()

  m = engine.metrics(state)
  supersteps = warm + timed + fenced
  if m.learn_steps < 20:
    fail(f"only {m.learn_steps} learn steps")
  if not math.isfinite(m.last_loss):
    fail(f"loss is not finite: {m.last_loss}")
  for name, n in counts.items():
    if n == 0:
      fail(f"kernel {name} was not launched on the main path")
  if m.replay_size < engine.spec.min_replay_capacity_fraction * \
      cfg.replay_capacity:
    fail("replay below its min fill after learning")
  if int(estate.env_frames) <= 0:
    fail("eval ran no frames")

  # Outputs: Q-values of the current observations through the kernels are
  # finite, of shape (128, 6), and agree with the plain torso.
  from dqn_zoo_torch.nets import atari, torso_cuda
  with torch.no_grad():
    obs = state.stack.frames
    q = engine.network.apply(state.online_params, obs).q_values
    t = state.online_params["torso"]
    plain = atari.dqn_value_head(state.online_params["head"],
                                 torso_cuda.torso_plain(
                                     t["conv1"]["w"], t["conv1"]["b"],
                                     t["conv2"]["w"], t["conv2"]["b"],
                                     t["conv3"]["w"], t["conv3"]["b"], obs))
  if tuple(q.shape) != (128, 6) or not bool(torch.isfinite(q).all()):
    fail(f"bad Q-values {tuple(q.shape)}")
  torch.testing.assert_close(q, plain, rtol=1e-4, atol=1e-5)

  agent_steps = timed * cfg.num_envs
  mean_ms = lambda xs: 1e3 * sum(xs) / len(xs) if xs else None
  summary = dict(
      supersteps=supersteps, learn_steps=m.learn_steps,
      last_loss=m.last_loss, replay_size=m.replay_size,
      env_frames=m.env_frames, warm_s=t_warm,
      timed_supersteps=timed,
      env_steps_per_s=agent_steps / t_run,
      env_frames_per_s=4 * agent_steps / t_run,
      ms_per_superstep=1e3 * t_run / timed,
      reset_supersteps_in_timed=len(step_s[True]),
      episodes_ended_in_timed=episodes_in_timed,
      host_ms_per_reset_superstep=mean_ms(step_s[True]),
      host_ms_per_other_superstep=mean_ms(step_s[False]),
      split_ms_per_superstep={k: 1e3 * v / fenced for k, v in split.items()},
      eval_frames=int(estate.env_frames),
      train_launches=train_counts,
      launches_per_learning_superstep=per_learning_superstep,
      eval_launches={k: counts[k] - train_counts[k] for k in counts},
      q_max_abs_err=float((q - plain).abs().max()),
      peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
  print("MAIN " + json.dumps(summary), flush=True)
  return counts


def main() -> int:
  if not torch.cuda.is_available():
    print("chip_smoke: no CUDA card; nothing was run.", file=sys.stderr)
    return 1
  here = os.path.dirname(os.path.abspath(__file__))
  if not os.path.isdir(os.path.join(here, "dqn_zoo_torch")):
    print("chip_smoke: dqn_zoo_torch/ is not beside this script.",
          file=sys.stderr)
    return 1
  sys.path.insert(0, here)
  from dqn_zoo_torch import kernels
  from dqn_zoo_torch.device import resolve_device
  dev = resolve_device("cuda")

  t0 = time.perf_counter()
  built = kernels.build_all()
  for k in kernels.REGISTRY.values():  # load every library now
    k._func()
  print(f"BUILD {time.perf_counter() - t0:.2f} s "
        f"{json.dumps(built)}", flush=True)

  checks = phase_kernels(dev)
  torch.cuda.empty_cache()
  counts = phase_main_path(dev)

  line = {"kernels": [dict(
      name=name, route="cuda", source=SOURCES[name],
      replaces=TPU_KERNELS[name], launches=counts[name],
      max_abs_err=checks[name]["max_abs_err"], ms=checks[name]["ms"],
      plain_ms=checks[name]["plain_ms"], bound_ms=checks[name]["bound_ms"],
      bound_by=checks[name]["bound_by"],
      library_ms=checks[name]["library_ms"]) for name in TPU_KERNELS]}
  print(json.dumps(line))
  smi = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit",
       "--format=csv,noheader"], capture_output=True, text=True, check=True)
  print(smi.stdout.strip().splitlines()[0])
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}))
  return 0


if __name__ == "__main__":
  sys.exit(main())
