"""Chip smoke test of the PyTorch/CUDA port (dqn_zoo_torch) on one card.

  python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and carried on):
  1. build every CUDA kernel from dqn_zoo_torch/csrc (one nvcc per source,
     all in parallel) and print the build time and what `-Xptxas -v` says
     of each kernel (registers, static shared memory, spills; K4a's bf16
     kernel's, K4b's and K4c's, both modes, and K2's dynamic shared memory
     beside it);
  2. hold each kernel against its plain PyTorch version at the main paths'
     shapes (K1 at W = 5 and W = 7; K4a, K4b and K4c also in their
     bf16-operand mode, bound at the bf16 rate, each after the staging
     pass that rounds its operands: K4a's at the act, learn, eval and a
     ragged shape), and time kernel, plain
     version, library call and bound; then SEAQUEST: 64 groups of the
     port's vector seaquest at 128 envs on the card and on the CPU from the
     same draws
     (per-frame diver spawns, noop burns) and actions, every output
     (frames, rewards, lives, ...) and state field required bit for bit;
     GAMES: the same for breakout, space_invaders, freeway, asterix,
     atlantis, skiing, assault, beam_rider, bowling, boxing, crazy_climber,
     demon_attack, enduro, fishing_derby, gopher, ice_hockey, ms_pacman,
     phoenix, qbert, star_gunner, tennis and zaxxon, 32 groups each under a
     48-frame episode cap (each runs its reset branch); PIL: the exact Pillow resize on the card
     reproduces the golden digest of tests/test_pil_resize.py, and 128
     pooled breakout frames give the same observations at `pil` on the card
     and on the CPU;
  3. drive the first main path — build_engine("dqn", "pong", num_envs=128,
     replay_capacity=1e6) in throughput mode (batch 1024) — through enough
     supersteps for >= 20 learn steps (a timed window of 600, which holds
     episode resets), then one eval chunk; check the loss,
     the outputs and that every kernel of that path was launched;
     then BF16_MAIN, the same trainer at compute_dtype=bfloat16 (20 warm,
     100 timed, 20 fenced supersteps): K1 1, K2 1 and K3a, K3b 0 a
     learning superstep (the cast torso on cuDNN), its Q-values against
     the same network on the CPU, its ms a superstep beside 3.'s;
  4. drive the prioritized path — build_engine("prioritized", "pong",
     num_envs=128, replay_capacity=1e6) in throughput mode with 3's lowered
     min fill — through 360 supersteps (300 timed, 40 with a fenced split);
     check the loss, that learning moved the max-seen priority and the value
     tree off their insert values, the IS weights of a fresh batch, the
     outputs and the launches per learning superstep (K3a three times: act,
     target and the double-Q selector);
  4b. drive the rainbow path (RAINBOW_MAIN) — build_engine("rainbow", "pong",
     num_envs=128, replay_capacity=1e6): batch 1024, n-step 3 (K1 windows of
     7 rows) under prioritized replay, the noisy dueling C51 net, clip +
     Adam — with 3's lowered min fill through 364 supersteps (300 timed, 40
     fenced); check the loss, the priorities (in [0, 100]), the outputs
     against the plain torso under the same noise, the launches per learning
     superstep (K1 1, K2 1, K3a 3, K3b 1) and the replay-less checkpoint's
     size; then RAINBOW_BREAKOUT_MAIN, the same trainer on breakout (4
     actions): 24 warm, 40 timed and 20 fenced supersteps and a
     100-superstep eval chunk on 4 envs, the same checks; then
     RAINBOW_ZAXXON_MAIN, the same phase on zaxxon (18 actions, so the
     noisy dueling head at 18 x 51 atoms; 3 lives, the reset branch
     counted) at the same depth; then PIL_MAIN,
     the dqn/pong trainer at --resize_method=pil for 40 supersteps: K2 must
     not launch, K1, K3a and K3b must (1, 2, 1 a learning superstep);
     then HOST_MAIN, the dqn/pong trainer at 3.'s config over the C++ farm
     (HostEnvEngine over CppVectorEnv("pong", 128), the farm built from
     cpp/dz_env.cc with g++ first): 20 warm, 200 timed, 40 fenced (farm,
     upload, act, insert, learn) and 20 probe supersteps, the probe timing
     how long the farm stepped while the card still ran the learn block;
     K2 must not launch (the farm preprocesses on the host), K1, K3a and
     K3b must (1, 2, 1 a learning superstep), and the rows the probe
     inserted must be the farm's observations; then OVERLAP_MAIN, 3.'s
     trainer with overlap_env_learn=True from 3.'s seed: 20 warm, 40 timed
     and 20 fenced supersteps, K1 1, K2 1, K3a 2, K3b 1 a learning
     superstep, learning from one superstep after 3.'s, its ms a superstep
     printed beside 3.'s;
  4c. drive the c51 and qrdqn paths on seaquest (C51_MAIN, QRDQN_MAIN) —
     build_engine("c51" or "qrdqn", "seaquest", num_envs=128,
     replay_capacity=1e6): batch 1024, 18 actions, 51 atoms on ±10 or 201
     quantiles, clip + Adam, uniform replay — with 3's lowered min fill
     through 80 supersteps (20 warm, 40 timed, 20 fenced), then one eval
     chunk; check the loss (c51's from log 51), the outputs against the
     plain torso, the launches per learning superstep (K1 1, K2 1, K3a 2,
     K3b 1) and print the replay-less checkpoint's bytes against 64 MiB,
     the most a chain of training legs carries from one run to the next;
     then DOUBLE_Q_MAIN, the same phase for build_engine("double_q",
     "demon_attack", num_envs=128, replay_capacity=1e6): 6 actions, the
     shared-bias DQN head, centred RMSProp, K3a three times a learning
     superstep (act, target and the double-Q selector), the timed
     supersteps that took the reset branch counted;
  5. drive the iqn path — build_engine("iqn", "pong", num_envs=128,
     replay_capacity=1e6) at the agent's own min fill: 120 acting and
     replay-filling supersteps, on past the min fill through >= 20 learn
     steps (a timed window of 40 learning supersteps, then a fenced split),
     then one eval chunk; check the loss, the outputs, that the parameters
     moved and that every kernel of that path was launched as often as the
     path says (K1 1, K2 1, K3a 2, K3b 1, K4a 3, K4b 1, K4c 1 a learning
     superstep), and print the replay-less checkpoint's bytes; then
     IQN_BF16_HEAD, the same phase with the network built at
     head_matmul_dtype=bfloat16 (the bf16 entries of K4a, K4b and K4c 2,
     1, 1, 1 a learning superstep, the backward's staging pass 1 and
     K4a's 3, one a K4a launch, their f32 entries 0), its ms a learning
     superstep beside the f32 head's; then
     IQN_MS_PACMAN_MAIN, the same phase for build_engine("iqn",
     "ms_pacman", ...): 9 actions (K4a's last column tile ragged), episodes
     cut short by lost lives, the timed supersteps that took the reset
     branch counted;
  6. checkpoint/resume of the dqn/pong trainer at 5.'s shapes (RESUME):
     save with and without the replay (the 7.06 GB frame store), restore
     into a second engine and require every entry bit for bit; 40
     supersteps from the live state, from a copy of it and from the
     restored state under cuDNN's deterministic algorithms, all three bit
     for bit (the default algorithms' run-to-run spread is printed); then
     two legs of the CLI, the first cut partway through its train phase by
     --max_run_seconds, the second resuming at the saved superstep; it
     prints the save and restore seconds, the checkpoint bytes and the
     peak memory on the card and the host;
  7. data parallelism (parallel/distributed.py, run/train_dist.py):
     DIST_MAIN drives dqn/pong through DistributedTrainer at world size 1
     over NCCL at MAIN's config (20 warm, 100 timed, 20 fenced supersteps;
     K1 1, K2 1, K3a 2, K3b 1 a learning superstep), times the gradient
     all-reduce alone at the net's size, and runs 40 supersteps of the
     trainer and of a plain Engine from one state under cuDNN's
     deterministic algorithms, which must agree bit for bit;
     DIST_TWO_RANKS runs two worker processes of this script
     (`--dist-worker`) on the one card over gloo (NCCL takes one card a
     rank): global 128 streams and replay 1e6 split over the two, batch
     512 each, frame multiplier 2, 20 warm and 40 timed supersteps; the
     ranks' parameters must be equal bit for bit, their replay frames must
     differ and the summed metrics must equal the ranks' own; DIST_CLI runs
     `torchrun --nproc_per_node=1 -m dqn_zoo_torch.run.train
     --mesh_devices=1` for one train and one eval iteration, with a
     replay-less rank checkpoint, and reads its 14-column CSV;
  8. print the kernels line, the card's name and power limit, and last the
     result line {"ok": true, "device": {...}}.
The launch counters are set to 0 just before each path and read just after;
each path's peak memory on the card is its own (the peak is reset before
it).
Needs a CUDA card and a C++ compiler (g++, or $CXX, for the farm); imports
nothing of JAX or of dqn_zoo_tpu.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import re
import subprocess
import sys
import time

import torch

# Published peaks of one H100 SXM at its 700 W limit (dense, no sparsity):
# HBM3 bandwidth, float32 outside the tensor cores, and TF32 on them. An
# f32-accurate product on the tensor cores takes three TF32 products
# (3xTF32), so 3 * flops / PEAK_TF32_FLOPS is the least time the card could
# take for f32-accurate work: `bound_3xtf32_ms`, beside `bound_ms` at f32.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
# bf16 on the tensor cores: the rate for the work of the IQN head's
# bf16-operand mode (its products' operands are bf16).
PEAK_BF16_FLOPS = 989e12
# Input sets a memory-bound kernel's timing rotates through (see time_ms).
ROTATE = 8

TPU_KERNELS = {
    "gather_windows": "dqn_zoo_tpu/replay/window_gather.py:78",
    "pooled_frame_to_84": "dqn_zoo_tpu/prep/pallas_prep.py:63",
    "dqn_torso_fwd": "dqn_zoo_tpu/nets/torso_pallas.py:159",
    "dqn_torso_fwd_residuals": "dqn_zoo_tpu/nets/torso_pallas.py:112",
    "iqn_head_fwd": "dqn_zoo_tpu/nets/iqn_head.py:115",
    "iqn_head_fwd_residuals": "dqn_zoo_tpu/nets/iqn_head.py:115",
    "iqn_head_bwd_w": "dqn_zoo_tpu/nets/iqn_head.py:155",
    "iqn_head_bwd_d": "dqn_zoo_tpu/nets/iqn_head.py:203",
    # The same TPU kernels with mm = bfloat16 (their bf16-operand mode).
    "iqn_head_fwd_bf16": "dqn_zoo_tpu/nets/iqn_head.py:115",
    "iqn_head_fwd_residuals_bf16": "dqn_zoo_tpu/nets/iqn_head.py:115",
    "iqn_head_bwd_w_bf16": "dqn_zoo_tpu/nets/iqn_head.py:155",
    "iqn_head_bwd_d_bf16": "dqn_zoo_tpu/nets/iqn_head.py:203",
    # The staging pass of the last two replaces no TPU kernel: it is the
    # bf16 rounding of the reference's `_dot`, done once for both.
    "iqn_head_stage_bf16": "none (the operand rounding of `_dot`, "
                           "dqn_zoo_tpu/nets/iqn_head.py:92)",
    # So does K4a's bf16 staging pass: the same rounding of the weights,
    # laid out as the kernel's shared-memory stages, once a launch.
    "iqn_head_stage_fwd_bf16": "none (the operand rounding of `_dot`, "
                               "dqn_zoo_tpu/nets/iqn_head.py:92)",
}
SOURCES = {
    "gather_windows": "dqn_zoo_torch/csrc/window_gather.cu",
    "pooled_frame_to_84": "dqn_zoo_torch/csrc/pooled_frame_to_84.cu",
    "dqn_torso_fwd": "dqn_zoo_torch/csrc/dqn_torso.cu",
    "dqn_torso_fwd_residuals": "dqn_zoo_torch/csrc/dqn_torso.cu",
    "iqn_head_fwd": "dqn_zoo_torch/csrc/iqn_head.cu",
    "iqn_head_fwd_residuals": "dqn_zoo_torch/csrc/iqn_head.cu",
    "iqn_head_bwd_w": "dqn_zoo_torch/csrc/iqn_head_bwd.cu",
    "iqn_head_bwd_d": "dqn_zoo_torch/csrc/iqn_head_bwd.cu",
    "iqn_head_fwd_bf16": "dqn_zoo_torch/csrc/iqn_head_bf16.cu",
    "iqn_head_fwd_residuals_bf16": "dqn_zoo_torch/csrc/iqn_head_bf16.cu",
    "iqn_head_stage_fwd_bf16": "dqn_zoo_torch/csrc/iqn_head_bf16.cu",
    "iqn_head_bwd_w_bf16": "dqn_zoo_torch/csrc/iqn_head_bwd_bf16.cu",
    "iqn_head_bwd_d_bf16": "dqn_zoo_torch/csrc/iqn_head_bwd_bf16.cu",
    "iqn_head_stage_bf16": "dqn_zoo_torch/csrc/iqn_head_bwd_bf16.cu",
}
# The kernels each main path must launch.
PATH_KERNELS = {
    "dqn": ("gather_windows", "pooled_frame_to_84", "dqn_torso_fwd",
            "dqn_torso_fwd_residuals"),
    "prioritized": ("gather_windows", "pooled_frame_to_84", "dqn_torso_fwd",
                    "dqn_torso_fwd_residuals"),
    "iqn": ("gather_windows", "pooled_frame_to_84", "dqn_torso_fwd",
            "dqn_torso_fwd_residuals", "iqn_head_fwd",
            "iqn_head_fwd_residuals", "iqn_head_bwd_w", "iqn_head_bwd_d"),
    "iqn_ms_pacman": ("gather_windows", "pooled_frame_to_84",
                      "dqn_torso_fwd", "dqn_torso_fwd_residuals",
                      "iqn_head_fwd", "iqn_head_fwd_residuals",
                      "iqn_head_bwd_w", "iqn_head_bwd_d"),
    "resume": ("gather_windows", "pooled_frame_to_84", "dqn_torso_fwd",
               "dqn_torso_fwd_residuals"),
    "rainbow": ("gather_windows", "pooled_frame_to_84", "dqn_torso_fwd",
                "dqn_torso_fwd_residuals"),
    "c51": ("gather_windows", "pooled_frame_to_84", "dqn_torso_fwd",
            "dqn_torso_fwd_residuals"),
    "qrdqn": ("gather_windows", "pooled_frame_to_84", "dqn_torso_fwd",
              "dqn_torso_fwd_residuals"),
    "double_q": ("gather_windows", "pooled_frame_to_84", "dqn_torso_fwd",
                 "dqn_torso_fwd_residuals"),
    "rainbow_breakout": ("gather_windows", "pooled_frame_to_84",
                         "dqn_torso_fwd", "dqn_torso_fwd_residuals"),
    "rainbow_zaxxon": ("gather_windows", "pooled_frame_to_84",
                       "dqn_torso_fwd", "dqn_torso_fwd_residuals"),
    # The exact Pillow resize takes the place of K2's `fast` one.
    "pil": ("gather_windows", "dqn_torso_fwd", "dqn_torso_fwd_residuals"),
    # The C++ farm preprocesses on the host: no K2.
    "host": ("gather_windows", "dqn_torso_fwd", "dqn_torso_fwd_residuals"),
    "overlap": ("gather_windows", "pooled_frame_to_84", "dqn_torso_fwd",
                "dqn_torso_fwd_residuals"),
    # The host replay gathers and the processor resizes on the host: no K1,
    # no K2.
    "host_agent": ("dqn_torso_fwd", "dqn_torso_fwd_residuals"),
    # dqn/pong through DistributedTrainer: one rank over NCCL, and two
    # ranks (their launches summed) over gloo on the one card.
    "dist": ("gather_windows", "pooled_frame_to_84", "dqn_torso_fwd",
             "dqn_torso_fwd_residuals"),
    "dist_two_ranks": ("gather_windows", "pooled_frame_to_84",
                       "dqn_torso_fwd", "dqn_torso_fwd_residuals"),
    # dqn/pong at compute_dtype=bfloat16: the cast torso on cuDNN, no K3
    # (the reference's fused torso computes in f32 only).
    "bf16": ("gather_windows", "pooled_frame_to_84"),
    # iqn/pong with the head's bf16-operand mode: the f32 torso (K3), the
    # bf16 entries of K4a, K4b and K4c and their two staging passes.
    "iqn_bf16_head": ("gather_windows", "pooled_frame_to_84",
                      "dqn_torso_fwd", "dqn_torso_fwd_residuals",
                      "iqn_head_fwd_bf16", "iqn_head_fwd_residuals_bf16",
                      "iqn_head_bwd_w_bf16", "iqn_head_bwd_d_bf16",
                      "iqn_head_stage_bf16", "iqn_head_stage_fwd_bf16"),
}
# Launches a learning superstep of dqn/pong (act and target: K3a twice).
DQN_PER_LEARNING_SUPERSTEP = {"gather_windows": 1, "pooled_frame_to_84": 1,
                              "dqn_torso_fwd": 2,
                              "dqn_torso_fwd_residuals": 1}
# The games GAMES holds card against CPU, beside pong, catch and seaquest.
NEW_GAMES = ("breakout", "space_invaders", "freeway", "asterix", "atlantis",
             "skiing", "assault", "beam_rider", "bowling", "boxing",
             "crazy_climber", "demon_attack", "enduro", "fishing_derby",
             "gopher", "ice_hockey", "ms_pacman", "phoenix", "qbert",
             "star_gunner", "tennis", "zaxxon")
# tests/test_pil_resize.py's digest of Pillow's resize of RandomState(42)'s
# (210, 160) image.
GOLDEN_RESIZE_DIGEST = (
    "a28154a96c0bab2071ed282033e28a42c60bf414c8842183bedc25f0dc5798eb")


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


def graph_ms(fn, sets=((),), reps: int = 5) -> float:
  """Mean device milliseconds per call with the host out of the way: the
  calls (each set in `sets` twice) are captured once into a CUDA graph,
  which is replayed `reps` times between CUDA events. For a kernel of tens
  of microseconds whose wrapper's own host time comes close to it, this
  separates the kernel from its launch cost; `time_ms` keeps both."""
  for args in sets:
    fn(*args)
  torch.cuda.synchronize()
  graph = torch.cuda.CUDAGraph()
  with torch.cuda.graph(graph):
    for args in list(sets) * 2:
      fn(*args)
  graph.replay()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(reps):
    graph.replay()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / (reps * 2 * len(sets))


def bound(nbytes: float, flops: float, peak_flops: float = PEAK_F32_FLOPS):
  t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
  t_ops = flops / peak_flops * 1e3
  return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound_3xtf32(nbytes: float, flops: float):
  """The larger of the byte time and 3 * flops at the TF32 peak, for a
  kernel bound by operations at f32; None for one bound by bytes."""
  if bound(nbytes, flops)[1] != "operations":
    return None
  return max(nbytes / PEAK_BYTES_PER_S, 3 * flops / PEAK_TF32_FLOPS) * 1e3


def ptxas_report(log: str):
  """[{function, registers, static_smem_bytes, spill_stores, spill_loads}]
  from nvcc's `-Xptxas -v` output."""
  out, name, spills = [], None, (0, 0)
  for line in log.splitlines():
    m = re.search(r"Compiling entry function '(\S+)'", line)
    if m:
      name = m.group(1)
    m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
    if m:
      spills = (int(m.group(1)), int(m.group(2)))
    m = re.search(r"Used (\d+) registers", line)
    if m and name:
      smem = re.search(r"(\d+) bytes smem", line)
      out.append(dict(function=name, registers=int(m.group(1)),
                      static_smem_bytes=int(smem.group(1)) if smem else 0,
                      spill_stores=spills[0], spill_loads=spills[1]))
      name, spills = None, (0, 0)
  return out


def phase_kernels(dev):
  """Each kernel against its plain version at the main path's shapes."""
  from dqn_zoo_torch.nets import iqn_head, torso_cuda
  from dqn_zoo_torch.nets.core import hwio_to_oihw
  from dqn_zoo_torch.prep import atari as tprep
  from dqn_zoo_torch.prep import cuda_prep
  from dqn_zoo_torch.replay import window_gather as twg

  gen = torch.Generator(device=dev)
  gen.manual_seed(0)
  results = {}

  def report(name, shape, err, tol, ms, plain_ms, library_ms, nbytes, flops,
             peak_flops=PEAK_F32_FLOPS, **extra):
    b_ms, b_by = bound(nbytes, flops, peak_flops)
    line = dict(name=name, shape=shape, max_abs_err=err, tolerance=tol,
                ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=b_ms, bound_by=b_by, **extra)
    tc = bound_3xtf32(nbytes, flops)
    if tc is not None and peak_flops == PEAK_F32_FLOPS:
      line["bound_3xtf32_ms"] = tc
    print("KERNEL_CHECK " + json.dumps(line), flush=True)
    return line

  # K1: B = 1024 windows of W rows from 128 streams: W = 5 (n-step 1 and a
  # stack of 4: dqn, prioritized, iqn) and W = 7 (rainbow's n-step 3), where
  # a window of 49,392 bytes is two pieces of a block's copy. Exact. Timing
  # rotates through 8 index sets, 289 MB (W = 5) or 405 MB (W = 7) of rows
  # from a 1.85 GB store; the indices are int64, as the replay's sample
  # path hands them in.
  b, s, r = 1024, 128, 2048
  frames = torch.randint(0, 256, (s, r, 84, 84), generator=gen, device=dev,
                         dtype=torch.uint8)
  flat = frames.view(s * r, 84 * 84)
  for w, role in ((5, "dqn, prioritized, iqn"), (7, "rainbow")):
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
        fail(f"K1 gather_windows at W={w} differs from its plain version")
    kernel = lambda st, sa, _: twg.gather_windows(frames, st, sa, w)
    library = lambda _, __, rw: torch.index_select(flat, 0, rw)
    line = report(
        "gather_windows", f"B={b} W={w}", 0.0, "exact",
        time_ms(kernel, sets),
        time_ms(lambda st, sa, _: twg.gather_windows_plain(frames, st, sa, w),
                sets),
        time_ms(library, sets), 2 * b * w * 84 * 84 + 8 * b, 0,
        graph_ms=graph_ms(kernel, sets),
        library_graph_ms=graph_ms(library, sets), role=role)
    if w == 5:
      results["gather_windows"] = line
    del sets
  del frames, flat

  # K2 at B = 128 (train) and B = 4 (eval), 8 sets of env frame pairs each,
  # one penultimate frame of each set all zero. At B = 128 the 8 sets (206
  # MB) exceed the 50 MB L2, so each call reads from HBM; at B = 4 they (6.5
  # MB) stay in L2, as the eval path's freshly rendered frames do. The
  # kernel sums each output's taps in a fixed order: it must equal the plain
  # version bit for bit, and two launches must give the same bits.
  for b, role in ((128, "train"), (4, "eval")):
    sets = []
    for _ in range(ROTATE):
      f1 = torch.randint(0, 256, (b, 210, 160, 3), generator=gen, device=dev,
                         dtype=torch.uint8)
      f2 = torch.randint(0, 256, (b, 210, 160, 3), generator=gen, device=dev,
                         dtype=torch.uint8)
      f1[0] = 0
      sets.append((f1, f2))
    got = [cuda_prep.pooled_frame_to_84(*fs) for fs in sets]
    repeat = all(torch.equal(g, cuda_prep.pooled_frame_to_84(*fs))
                 for g, fs in zip(got, sets))
    want = [tprep.pooled_frame_to_84_plain(*fs) for fs in sets]
    diff = (torch.cat(got).int() - torch.cat(want).int()).abs()
    differing = int((diff != 0).sum())
    if differing:
      fail(f"K2 at B={b} differs from its plain version in {differing} "
           f"pixels, by up to {int(diff.max())}")
    if not repeat:
      fail(f"K2 at B={b}: two launches gave different bits")
    nbytes, flops = cuda_prep.bound_counts(b)
    mb = 2 * ROTATE * b * 210 * 160 * 3 / 1e6
    line = report(
        "pooled_frame_to_84", f"B={b}", float(diff.max()), "exact",
        time_ms(cuda_prep.pooled_frame_to_84, sets),
        time_ms(tprep.pooled_frame_to_84_plain, sets), None, nbytes, flops,
        graph_ms=graph_ms(cuda_prep.pooled_frame_to_84, sets),
        role=role, exact_share=float((diff == 0).float().mean()),
        differing_pixels=differing, bit_identical_repeat=repeat,
        band_rows=cuda_prep.BAND_ROWS,
        inputs=f"{ROTATE} sets, {mb:.1f} MB together: " + (
            "more than the 50 MB L2, read from HBM" if mb > 50 else
            "in the 50 MB L2, as the eval path's fresh frames are"))
    if role == "train":
      results["pooled_frame_to_84"] = line
    del sets, got, want

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

  # K3a at B = 1 (the host agent's act), 4 (eval), 32 (the host agent's
  # target net), 128 (act) and 1024 (target). The kernel's products run in
  # 3xTF32 (f32-accurate), the plain version's in f32 with TF32 off: the
  # sums differ in order and rounding, so rtol 1e-4 holds with room. Two
  # launches give the same bits.
  k3a_roles = {1: "host agent act", 4: "eval", 32: "host agent target",
               128: "act", 1024: "target"}
  for b, role in k3a_roles.items():
    x = torch.randint(0, 256, (b, 84, 84, 4), generator=gen, device=dev,
                      dtype=torch.uint8)
    with torch.no_grad():
      got = torso_cuda.dqn_torso(*ws, x)
      want = torso_cuda.torso_plain(*ws, x)
      torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
      if not torch.equal(got, torso_cuda.dqn_torso(*ws, x)):
        fail(f"K3a at B={b}: two launches differ")
      xn = x.permute(0, 3, 1, 2).float().mul(1.0 / 255.0).contiguous()
      nbytes, flops = torso_cuda.bound_counts(b, residuals=False)
      kernel = lambda: torso_cuda.torso_forward(ws, x, residuals=False)
      line = report(
          "dqn_torso_fwd", f"B={b}", float((got - want).abs().max()),
          "rtol 1e-4, atol 1e-5",
          time_ms(kernel), time_ms(lambda: torso_cuda.torso_plain(*ws, x)),
          time_ms(lambda: library(xn)), nbytes, flops,
          graph_ms=graph_ms(kernel), bit_identical_repeat=True, role=role)
    if b == 1024:
      results["dqn_torso_fwd"] = line

  # K3b at B = 32 (the host agent's online net) and 1024 (the online net
  # under grad), and the gradients through its autograd Function. Where a
  # pre-activation lies within f32 rounding of 0, the kernel and the plain
  # forward may take different ReLU branches (a few of the 17 M activations
  # at B = 1024), and each such flip moves a weight gradient by a whole
  # term. So the reference for the gradients is autograd of the plain
  # convolutions with the kernel's own ReLU masks: it checks the backward
  # independently of those flips, and must agree to a relative Frobenius
  # error of 1e-4. The flips are counted and printed.
  for b, role in ((32, "host agent online"), (1024, "online")):
    if b != x.shape[0]:
      x = torch.randint(0, 256, (b, 84, 84, 4), generator=gen, device=dev,
                        dtype=torch.uint8)
      xn = x.permute(0, 3, 1, 2).float().mul(1.0 / 255.0).contiguous()
    got, z1, z2 = torso_cuda.torso_forward(ws, x, residuals=True)
    want, wz1, wz2 = torso_cuda.torso_plain_residuals(*ws, x)
    for a, e in ((got, want), (z1, wz1), (z2, wz2)):
      torch.testing.assert_close(a, e, rtol=1e-4, atol=1e-5)
    if not all(torch.equal(a, e) for a, e in zip(
        (got, z1, z2), torso_cuda.torso_forward(ws, x, residuals=True))):
      fail(f"K3b at B={b}: two launches differ")
    flips = sum(int(((a > 0) != (e > 0)).sum())
                for a, e in ((got, want), (z1, wz1), (z2, wz2)))
    masks = [(t > 0).float() for t in (z1, z2, got.reshape(-1, 7, 7, 64))]

    dy = torch.randn((b, 3136), generator=gen, device=dev)
    pa = [t.clone().requires_grad_(True) for t in ws]
    pb = [t.clone().requires_grad_(True) for t in ws]
    ga = torch.autograd.grad((torso_cuda.dqn_torso(*pa, x) * dy).sum(), pa)
    gb = torch.autograd.grad(
        (torso_cuda.torso_plain_masked(*pb, x, masks) * dy).sum(), pb)
    grad_err = max(
        float(torch.linalg.vector_norm(a - e) / torch.linalg.vector_norm(e))
        for a, e in zip(ga, gb))
    print(f"K3b gradients at B={b}: relative Frobenius error "
          f"{grad_err:.3e} (ReLU branch flips against the plain forward: "
          f"{flips})", flush=True)
    if not grad_err <= 1e-4:
      fail(f"K3b gradients at B={b} differ from the plain version's: "
           f"{grad_err}")
    nbytes, flops = torso_cuda.bound_counts(b, residuals=True)
    with torch.no_grad():
      line = report(
          "dqn_torso_fwd_residuals", f"B={b}",
          float((got - want).abs().max()),
          "rtol 1e-4, atol 1e-5; grads relative Frobenius <= 1e-4",
          time_ms(lambda: torso_cuda.torso_forward(ws, x, residuals=True)),
          time_ms(lambda: torso_cuda.torso_plain_residuals(*ws, x)),
          time_ms(lambda: library(xn)), nbytes, flops,
          grad_rel_frobenius_err=grad_err, relu_branch_flips=flips,
          bit_identical_repeat=True, role=role)
    if b == 1024:
      results["dqn_torso_fwd_residuals"] = line

  # K4a: the fused IQN head at the published widths (latent 64, D = 3136,
  # H = 512), inputs at the scale of the reference's own test of its kernel.
  # f32 on both sides, TF32 off; the kernel sums each product in another
  # order than cuBLAS, so rtol 1e-4 with atol 1e-5 holds with room.
  def head_inputs(b, s, a):
    n = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    return (n(64, 3136) * 0.05, n(3136) * 0.05, n(3136, 512) * 0.015,
            n(512) * 0.05, n(512, a) * 0.05, n(a) * 0.05, n(b, s, 64),
            torch.relu(n(b, 3136)))

  def head_library(we, be, wh, bh, wo, bo, cos_emb, s_emb):
    # Three f32 addmm (cuBLAS, allow_tf32 False as set_numerics leaves it)
    # and the elementwise ops between them; te and hi go through memory.
    b, s, l = cos_emb.shape
    te = torch.addmm(be, cos_emb.reshape(b * s, l), we).relu_()
    hi = (te.view(b, s, -1) * s_emb[:, None, :]).view(b * s, -1)
    return torch.addmm(bo, torch.addmm(bh, hi, wh).relu_(), wo)

  if torch.backends.cuda.matmul.allow_tf32:
    fail("TF32 matmuls are on; the K4a reference must be full f32")
  # (B, S, A, residuals, role): act and eval shapes of the iqn main path, a
  # ragged shape, and the learn step's shapes (online net with residuals,
  # target net with selector and target taus concatenated), timed over 5
  # launches. `splits` is how many blocks share D per row tile (more than 1
  # where the row tiles alone would leave the card idle); a second launch
  # at the same shape must give the same bits.
  # The iqn/ms_pacman path's shapes (A = 9, a ragged last column tile)
  # follow pong's, and an 18-action game's (star_gunner, tennis, zaxxon)
  # those.
  shapes = [(128, 64, 6, False, "act"), (128, 64, 6, True, "act"),
            (4, 64, 6, False, "eval"), (4, 64, 6, True, "eval"),
            (3, 24, 18, False, "ragged"), (3, 24, 18, True, "ragged"),
            (1024, 64, 6, True, "learn_online"),
            (1024, 128, 6, False, "learn_target"),
            (128, 64, 9, False, "act_a9"),
            (1024, 64, 9, True, "learn_online_a9"),
            (1024, 128, 9, False, "learn_target_a9"),
            (128, 64, 18, False, "act_a18"),
            (1024, 64, 18, True, "learn_online_a18"),
            (1024, 128, 18, False, "learn_target_a18")]
  with torch.no_grad():
    for b, s, a, res, role in shapes:
      args = head_inputs(b, s, a)
      want_q, want_h = iqn_head.iqn_head_plain_residuals(*args)
      if res:
        got_q, got_h = iqn_head.iqn_head_forward(*args, residuals=True)
        torch.testing.assert_close(got_h, want_h, rtol=1e-4, atol=1e-5)
        extra = dict(h_max_abs_err=float((got_h - want_h).abs().max()))
      else:
        got_q = iqn_head.iqn_head_forward(*args, residuals=False)
        extra = {}
      torch.testing.assert_close(got_q, want_q, rtol=1e-4, atol=1e-5)
      again = iqn_head.iqn_head_forward(*args, residuals=res)
      if not torch.equal(again[0] if res else again, got_q) or \
          (res and not torch.equal(again[1], got_h)):
        fail(f"K4a at B={b} S={s}: two launches differ")
      del again
      err = float((got_q - want_q).abs().max())
      iters = 5 if role.startswith("learn") else 20
      name = "iqn_head_fwd_residuals" if res else "iqn_head_fwd"
      nbytes, flops = iqn_head.bound_counts(b, s, a, residuals=res)
      line = report(
          name, f"B={b} S={s} A={a}", err, "rtol 1e-4, atol 1e-5",
          time_ms(lambda: iqn_head.iqn_head_forward(*args, residuals=res),
                  iters=iters),
          time_ms(lambda: iqn_head.iqn_head_plain_residuals(*args),
                  iters=iters),
          time_ms(lambda: head_library(*args), iters=iters), nbytes, flops,
          role=role, splits=iqn_head.d_splits(b, s), **extra)
      # The kernels line takes each variant at the shape its path gives it:
      # q only when acting, q and h for the online net of the learn step.
      if role == ("learn_online" if res else "act"):
        results[name] = line

  results.update(check_head_backward(dev, gen, report, head_inputs))
  results.update(check_head_bf16(dev, gen, report, head_inputs))
  return results


def rel_frobenius(got, want) -> float:
  return float(torch.linalg.vector_norm(got - want)
               / torch.linalg.vector_norm(want))


def check_head_backward(dev, gen, report, head_inputs):
  """K4b and K4c against their plain versions at the learn, act, eval and
  ragged shapes (and each against a second launch of itself, bit for bit),
  then the gradients of all eight arguments through the autograd Function at
  the act shape."""
  from dqn_zoo_torch.nets import iqn_head

  def w_library(we, be, cos_emb, s_emb, dh):
    # cuBLAS f32 products; te and hi go through memory.
    b, s, l = cos_emb.shape
    te = torch.addmm(be, cos_emb.reshape(b * s, l), we).relu_()
    hi = (te.view(b, s, -1) * s_emb[:, None, :]).view(b * s, -1)
    return torch.mm(hi.t(), dh), dh.sum(dim=0)

  def d_library(we, be, wh, cos_emb, s_emb, dh, need_dcos):
    # cuBLAS f32 products; te_pre, dhi and dte go through memory.
    b, s, l = cos_emb.shape
    cos2 = cos_emb.reshape(b * s, l)
    te_pre = torch.addmm(be, cos2, we)
    dhi = torch.mm(dh, wh.t())
    ds_emb = (dhi * te_pre.relu()).view(b, s, -1).sum(dim=1)
    dte = (dhi.view(b, s, -1) * s_emb[:, None, :]).view(b * s, -1)
    dte.mul_(te_pre > 0)
    dcos = torch.mm(dte, we.t()) if need_dcos else None
    return torch.mm(cos2.t(), dte), dte.sum(dim=0), ds_emb, dcos

  def hold(name, shape, outputs, got, want, small):
    """Relative Frobenius error <= 1e-4 for every output and, at the small
    shapes, elementwise rtol 1e-4 with atol 1e-5 of the output's largest
    magnitude. Returns (largest abs error, largest Frobenius error)."""
    worst_abs = worst_fro = 0.0
    for out, g, w in zip(outputs, got, want):
      fro = rel_frobenius(g, w)
      if not fro <= 1e-4:
        fail(f"{name} {shape}: {out} differs from the plain "
             f"version's, relative Frobenius error {fro}")
      if small:
        torch.testing.assert_close(
            g, w, rtol=1e-4, atol=1e-5 * float(w.abs().max()))
      worst_abs = max(worst_abs, float((g - w).abs().max()))
      worst_fro = max(worst_fro, fro)
    return worst_abs, worst_fro

  results = {}
  tol = ("relative Frobenius <= 1e-4 per output; small shapes also rtol "
         "1e-4, atol 1e-5 x max|output|")
  shapes = [(1024, 64, 6, "learn"), (128, 64, 6, "act"), (4, 64, 6, "eval"),
            (3, 24, 18, "ragged")]
  with torch.no_grad():
    for b, s, a, role in shapes:
      we, be, wh, bh, wo, bo, cos_emb, s_emb = args = head_inputs(b, s, a)
      _, h = iqn_head.iqn_head_forward(*args, residuals=True)
      dq = torch.randn((b * s, a), generator=gen, device=dev)
      dh = ((dq @ wo.t()) * (h > 0)).contiguous()
      del h, dq
      shape = f"B={b} S={s}"
      small = role != "learn"
      iters = 20 if small else 5

      w_args = (we, be, cos_emb, s_emb, dh)
      got = iqn_head.iqn_head_bwd_w(*w_args)
      # Every sum over rows is taken in a fixed order: a second launch gives
      # the same bits.
      again = iqn_head.iqn_head_bwd_w(*w_args)
      if not all(torch.equal(u, v) for u, v in zip(got, again)):
        fail(f"K4b B={b} S={s}: two launches gave different bits")
      del again
      err, fro = hold("K4b", shape, ("dwh", "dbh"), got,
                      iqn_head.iqn_head_bwd_w_plain(*w_args), small)
      del got
      nbytes, flops = iqn_head.bound_counts_bwd_w(b, s)
      line = report(
          "iqn_head_bwd_w", shape, err, tol,
          time_ms(lambda: iqn_head.iqn_head_bwd_w(*w_args), iters=iters),
          time_ms(lambda: iqn_head.iqn_head_bwd_w_plain(*w_args),
                  iters=iters),
          time_ms(lambda: w_library(*w_args), iters=iters), nbytes, flops,
          role=role, rel_frobenius_err=fro, bit_identical_repeat=True)
      if role == "learn":
        results["iqn_head_bwd_w"] = line

      # K4c, all outputs (dcos included), against the plain version with
      # the kernel's own te_pre > 0 bits; the entries where the plain
      # version's own bits differ (te_pre within rounding of 0) are counted.
      d_args = (we, be, wh, cos_emb, s_emb, dh)
      *got, mask = iqn_head.iqn_head_bwd_d(*d_args, need_dcos=True,
                                           return_te_mask=True)
      # Every sum is taken in a fixed order: a second launch gives the same
      # bits.
      again = iqn_head.iqn_head_bwd_d(*d_args, need_dcos=True,
                                      return_te_mask=True)
      if not all(torch.equal(u, v) for u, v in zip((*got, mask), again)):
        fail(f"K4c B={b} S={s}: two launches gave different bits")
      del again
      flips = int((mask.bool() != (cos_emb.reshape(b * s, -1) @ we + be > 0))
                  .sum())
      err, fro = hold("K4c", shape, ("dwe", "dbe", "ds_emb", "dcos"), got,
                      iqn_head.iqn_head_bwd_d_plain(*d_args, te_mask=mask),
                      small)
      del got, mask
      # Timed as the learn step runs it (no dcos: the cosine features come
      # from drawn taus), and with dcos beside it.
      nbytes, flops = iqn_head.bound_counts_bwd_d(b, s, need_dcos=False)
      nbytes_c, flops_c = iqn_head.bound_counts_bwd_d(b, s, need_dcos=True)
      line = report(
          "iqn_head_bwd_d", shape, err, tol,
          time_ms(lambda: iqn_head.iqn_head_bwd_d(*d_args, need_dcos=False),
                  iters=iters),
          time_ms(lambda: iqn_head.iqn_head_bwd_d_plain(
              *d_args, need_dcos=False), iters=iters),
          time_ms(lambda: d_library(*d_args, False), iters=iters),
          nbytes, flops, role=role, rel_frobenius_err=fro,
          te_branch_flips=flips, bit_identical_repeat=True,
          with_dcos=dict(
              ms=time_ms(lambda: iqn_head.iqn_head_bwd_d(*d_args),
                         iters=iters),
              plain_ms=time_ms(lambda: iqn_head.iqn_head_bwd_d_plain(
                  *d_args), iters=iters),
              library_ms=time_ms(lambda: d_library(*d_args, True),
                                 iters=iters),
              bound_ms=bound(nbytes_c, flops_c)[0]))
      if role == "learn":
        results["iqn_head_bwd_d"] = line
      del dh

  # The autograd Function at the act shape: gradients of all eight
  # arguments against autograd of the plain head with the kernels' own ReLU
  # bits (h > 0 from K4a, te_pre > 0 from K4c), relative Frobenius <= 1e-4.
  b, s, a = 128, 64, 6
  args = head_inputs(b, s, a)
  dq = torch.randn((b, s, a), generator=gen, device=dev)
  before = [k.launches for k in (iqn_head.FWD_RES, iqn_head.BWD_W,
                                 iqn_head.BWD_D)]
  pa = [t.clone().requires_grad_(True) for t in args]
  ga = torch.autograd.grad((iqn_head.iqn_head(*pa) * dq).sum(), pa)
  after = [k.launches for k in (iqn_head.FWD_RES, iqn_head.BWD_W,
                                iqn_head.BWD_D)]
  if [y - x for x, y in zip(before, after)] != [1, 1, 1]:
    fail(f"iqn_head under grad launched {before} -> {after}, not one each of "
         "K4a with residuals, K4b and K4c")
  with torch.no_grad():
    we, be, wh, bh, wo, bo, cos_emb, s_emb = args
    _, h = iqn_head.iqn_head_forward(*args, residuals=True)
    dh = ((dq.reshape(b * s, a) @ wo.t()) * (h > 0)).contiguous()
    mask = iqn_head.iqn_head_bwd_d(we, be, wh, cos_emb, s_emb, dh,
                                   need_dcos=False, return_te_mask=True)[-1]
    _, plain_h = iqn_head.iqn_head_plain_residuals(*args)
    flips = int(((h > 0) != (plain_h > 0)).sum()) + int(
        (mask.bool() != (cos_emb.reshape(b * s, -1) @ we + be > 0)).sum())
  pb = [t.clone().requires_grad_(True) for t in args]
  gb = torch.autograd.grad(
      (iqn_head.iqn_head_plain_masked(*pb, mask.float(), (h > 0).float())
       * dq).sum(), pb)
  grad_err = max(rel_frobenius(x, y) for x, y in zip(ga, gb))
  print(f"K4 gradients through the autograd Function, B={b} S={s}: relative "
        f"Frobenius error {grad_err:.3e} (ReLU branch flips against the "
        f"plain forward: {flips})", flush=True)
  if not grad_err <= 1e-4:
    fail(f"iqn_head gradients differ from the plain version's: {grad_err}")
  results["iqn_head_bwd_d"]["function_grad_rel_frobenius_err"] = grad_err
  return results


def check_head_bf16(dev, gen, report, head_inputs):
  """K4a (both variants), K4b and K4c in their bf16-operand mode (mm =
  bf16) against their plain bf16 versions at the iqn path's shapes, each
  against a second launch of itself bit for bit; timed beside the plain
  version and the same products as bf16 cuBLAS calls (f32 accumulation,
  bf16 outputs) on inputs cast beforehand. Bound at the card's bf16 rate.
  Kernel and plain version round the same operands and sum exact products
  in other orders, so an f32 value differing in its last bits (te, hi, h,
  dte) may round to a neighbouring bf16 value in a few entries: each
  output is held to a relative Frobenius error of 1e-4, but q to 5e-4 (a
  sum of 512 products of bf16(h), where h's ~4e-4 flips move ~1e-4:
  tests/test_torch_cuda.py), and q must lie nearer the plain bf16 head than
  the f32 head does (a tenth of that distance); with h, q from the
  kernel's own h within 1e-5. K4a reads the weights as its staging pass
  (csrc/iqn_head_bf16.cu) lays them out, checked first: its bytes bit for
  bit the plain version's, bound by bytes. K4b and K4c take their operands
  from theirs (csrc/iqn_head_bwd_bf16.cu), checked next, likewise. Each
  kernel is timed on its staged operands, as cuBLAS is on operands cast
  beforehand, and with its staging pass beside (`ms_with_staging`)."""
  from dqn_zoo_torch.nets import iqn_head
  mm = torch.bfloat16
  bf = lambda *ts: [t.to(mm) for t in ts]
  results = {}
  tol = ("relative Frobenius <= 1e-4 per output, q <= 5e-4 (bf16 "
         "operands)")

  def fwd_library(we, be, wh, bh, wo, bo, cos2, s_emb, b, s):
    te = torch.addmm(be, cos2, we).relu_()
    hi = (te.view(b, s, -1) * s_emb[:, None, :]).view(b * s, -1)
    return torch.addmm(bo, torch.addmm(bh, hi, wh).relu_(), wo)

  with torch.no_grad():
    # K4a's staging pass: its bytes bit for bit the plain version's, and a
    # second launch the same bytes.
    we, be, wh = head_inputs(1, 1, 6)[:3]
    st = iqn_head.iqn_head_stage_fwd_bf16(we, be, wh)
    if not torch.equal(st, iqn_head.iqn_head_stage_fwd_bf16_plain(we, be,
                                                                  wh)):
      fail("K4a's staging pass differs from its plain version")
    if not torch.equal(st, iqn_head.iqn_head_stage_fwd_bf16(we, be, wh)):
      fail("K4a's staging pass: two launches gave different bytes")
    nbytes, flops = iqn_head.bound_counts_stage_fwd_bf16()
    stage = lambda: iqn_head.iqn_head_stage_fwd_bf16(we, be, wh)
    results["iqn_head_stage_fwd_bf16"] = report(
        "iqn_head_stage_fwd_bf16", "D=3136", 0.0, "bytes bit for bit",
        time_ms(stage, iters=20),
        time_ms(lambda: iqn_head.iqn_head_stage_fwd_bf16_plain(we, be, wh),
                iters=20),
        None, nbytes, flops, role="every K4a bf16 launch",
        graph_ms=graph_ms(stage), bit_identical_repeat=True)
    del we, be, wh, st

    # K4a at the iqn path's shapes (act, the learn step's target and online
    # nets), then eval (D split over blocks) and a ragged shape at A = 18
    # (streams straddle the warpgroups' rows: s_emb read row by row).
    for b, s, a, res, role in ((128, 64, 6, False, "act"),
                               (1024, 128, 6, False, "learn_target"),
                               (1024, 64, 6, True, "learn_online"),
                               (4, 64, 6, False, "eval"),
                               (3, 24, 18, True, "ragged")):
      args = head_inputs(b, s, a)
      st = iqn_head.iqn_head_stage_fwd_bf16(*args[:3])
      got = iqn_head.iqn_head_forward(*args, residuals=res, mm=mm,
                                      staged=st)
      again = iqn_head.iqn_head_forward(*args, residuals=res, mm=mm)
      want_q, want_h = iqn_head.iqn_head_plain_residuals(*args, mm=mm)
      f32_q = iqn_head.iqn_head_plain(*args)
      got, again = (got, again) if res else ((got,), (again,))
      if not all(torch.equal(u, v) for u, v in zip(got, again)):
        fail(f"K4a bf16 at B={b} S={s}: two launches differ")
      fro = rel_frobenius(got[0], want_q)
      f32_fro = rel_frobenius(f32_q, want_q)
      extra = {}
      if res:
        r = lambda t: t.to(mm).float()
        q_from_h = (r(got[1]) @ r(args[4]) + args[5]).reshape(b, s, -1)
        extra = dict(h_rel_frobenius_err=rel_frobenius(got[1], want_h),
                     q_from_own_h_rel_frobenius_err=rel_frobenius(
                         got[0], q_from_h))
      if not (fro <= 5e-4 and fro < 0.1 * f32_fro and
              extra.get("h_rel_frobenius_err", 0.0) <= 1e-4 and
              extra.get("q_from_own_h_rel_frobenius_err", 0.0) <= 1e-5):
        fail(f"K4a bf16 at B={b} S={s}: q {fro} (f32 head {f32_fro}), "
             f"{extra}")
      lib_args = bf(*args[:6]) + bf(args[6].reshape(b * s, -1), args[7])
      name = "iqn_head_fwd_residuals_bf16" if res else "iqn_head_fwd_bf16"
      nbytes, flops = iqn_head.bound_counts(b, s, a, residuals=res)
      iters = 5 if b == 1024 else 20
      kernel = lambda: iqn_head.iqn_head_forward(*args, residuals=res, mm=mm,
                                                 staged=st)
      library_ms = time_ms(lambda: fwd_library(*lib_args, b, s), iters=iters)
      line = report(
          name, f"B={b} S={s} A={a}", float((got[0] - want_q).abs().max()),
          tol, time_ms(kernel, iters=iters),
          time_ms(lambda: iqn_head.iqn_head_plain_residuals(*args, mm=mm),
                  iters=iters),
          library_ms, nbytes, flops, peak_flops=PEAK_BF16_FLOPS, role=role,
          rel_frobenius_err=fro, f32_head_rel_frobenius=f32_fro,
          bit_identical_repeat=True, splits=iqn_head.bf16_fwd_splits(b, s),
          graph_ms=graph_ms(kernel),
          ms_with_staging=time_ms(lambda: iqn_head.iqn_head_forward(
              *args, residuals=res, mm=mm), iters=iters),
          library_graph_ms=graph_ms(lambda: fwd_library(*lib_args, b, s)),
          **extra)
      if role in ("act", "learn_online"):
        results[name] = line
      del args, got, again, want_q, want_h, f32_q, lib_args, st

    b, s = 1024, 64
    args = head_inputs(b, s, 6)
    we, be, wh, _, wo, _, cos_emb, s_emb = args
    _, h = iqn_head.iqn_head_forward(*args, residuals=True, mm=mm)
    dq = torch.randn((b * s, 6), generator=gen, device=dev)
    dh = ((dq @ wo.t()) * (h > 0)).contiguous()
    del h, dq
    cos2 = cos_emb.reshape(b * s, -1)
    lb = bf(we, be, wh, cos2, s_emb, dh)

    # The staging pass, as the backward runs it (wh included): its bf16
    # copies bit for bit the plain version's, dbh (summed in another order)
    # within rtol 1e-5, atol 1e-6 x max|dbh|; a second launch the same bits.
    st = iqn_head.iqn_head_stage_bf16(we, cos_emb, dh, wh)
    again = iqn_head.iqn_head_stage_bf16(we, cos_emb, dh, wh)
    want = iqn_head.iqn_head_stage_bf16_plain(we, cos_emb, dh, wh)
    for name in ("dh", "cos", "we_t", "wh"):
      if not torch.equal(getattr(st, name).view(torch.int16),
                         getattr(want, name).view(torch.int16)):
        fail(f"staging: the bf16 copy of {name} differs from the plain one")
    if not all(torch.equal(u.view(torch.uint8), v.view(torch.uint8))
               for u, v in zip(st, again)):
      fail("staging: two launches gave different bits")
    torch.testing.assert_close(st.dbh, want.dbh, rtol=1e-5,
                               atol=1e-6 * float(want.dbh.abs().max()))
    nbytes, flops = iqn_head.bound_counts_stage_bf16(b, s)
    results["iqn_head_stage_bf16"] = report(
        "iqn_head_stage_bf16", f"B={b} S={s}",
        float((st.dbh - want.dbh).abs().max()),
        "bf16 copies bit for bit; dbh rtol 1e-5, atol 1e-6 x max|dbh|",
        time_ms(lambda: iqn_head.iqn_head_stage_bf16(we, cos_emb, dh, wh),
                iters=20),
        time_ms(lambda: iqn_head.iqn_head_stage_bf16_plain(we, cos_emb, dh,
                                                           wh), iters=20),
        None, nbytes, flops, role="learn", bit_identical_repeat=True,
        dbh_rel_frobenius_err=rel_frobenius(st.dbh, want.dbh))
    del again, want

    # K4b and K4c on the staged operands (each timed without the staging,
    # as bf16 cuBLAS is timed on operands cast beforehand; with it beside).
    w_args = (we, be, cos_emb, s_emb, dh)
    got = iqn_head.iqn_head_bwd_w(*w_args, mm=mm, staged=st)
    again = iqn_head.iqn_head_bwd_w(*w_args, mm=mm, staged=st)
    if not all(torch.equal(u, v) for u, v in zip(got, again)):
      fail("K4b bf16: two launches gave different bits")
    want = iqn_head.iqn_head_bwd_w_plain(*w_args, mm=mm)
    fros = [rel_frobenius(g, w) for g, w in zip(got, want)]
    if not max(fros) <= 1e-4:
      fail(f"K4b bf16 (dwh, dbh) against the plain version: {fros}")

    def w_library(we, be, wh, cos2, s_emb, dh):
      te = torch.addmm(be, cos2, we).relu_()
      hi = (te.view(b, s, -1) * s_emb[:, None, :]).view(b * s, -1)
      return torch.mm(hi.t(), dh), dh.sum(dim=0)

    nbytes, flops = iqn_head.bound_counts_bwd_w(b, s)
    results["iqn_head_bwd_w_bf16"] = report(
        "iqn_head_bwd_w_bf16", f"B={b} S={s}",
        max(float((g - w).abs().max()) for g, w in zip(got, want)), tol,
        time_ms(lambda: iqn_head.iqn_head_bwd_w(*w_args, mm=mm, staged=st),
                iters=5),
        time_ms(lambda: iqn_head.iqn_head_bwd_w_plain(*w_args, mm=mm),
                iters=5),
        time_ms(lambda: w_library(*lb), iters=5), nbytes, flops,
        peak_flops=PEAK_BF16_FLOPS, role="learn", rel_frobenius_err=max(fros),
        bit_identical_repeat=True, groups=iqn_head.bf16_groups_w(b, s),
        ms_with_staging=time_ms(
            lambda: iqn_head.iqn_head_bwd_w(*w_args, mm=mm), iters=5))
    del got, again, want

    d_args = (we, be, wh, cos_emb, s_emb, dh)
    *got, mask = iqn_head.iqn_head_bwd_d(*d_args, return_te_mask=True,
                                         mm=mm, staged=st)
    again = iqn_head.iqn_head_bwd_d(*d_args, return_te_mask=True, mm=mm,
                                    staged=st)
    if not all(torch.equal(u, v) for u, v in zip((*got, mask), again)):
      fail("K4c bf16: two launches gave different bits")
    want = iqn_head.iqn_head_bwd_d_plain(*d_args, te_mask=mask, mm=mm)
    fros = [rel_frobenius(g, w) for g, w in zip(got, want)]
    if not max(fros) <= 1e-4:
      fail(f"K4c bf16 (dwe, dbe, ds_emb, dcos) against the plain version: "
           f"{fros}")

    def d_library(we, be, wh, cos2, s_emb, dh):
      te_pre = torch.addmm(be, cos2, we)
      dhi = torch.mm(dh, wh.t())
      ds_emb = (dhi * te_pre.relu()).view(b, s, -1).sum(dim=1)
      dte = (dhi.view(b, s, -1) * s_emb[:, None, :]).view(b * s, -1)
      dte.mul_(te_pre > 0)
      return torch.mm(cos2.t(), dte), dte.sum(dim=0), ds_emb

    nbytes, flops = iqn_head.bound_counts_bwd_d(b, s, need_dcos=False)
    results["iqn_head_bwd_d_bf16"] = report(
        "iqn_head_bwd_d_bf16", f"B={b} S={s}",
        max(float((g - w).abs().max()) for g, w in zip(got, want)), tol,
        time_ms(lambda: iqn_head.iqn_head_bwd_d(*d_args, need_dcos=False,
                                                mm=mm, staged=st), iters=5),
        time_ms(lambda: iqn_head.iqn_head_bwd_d_plain(
            *d_args, need_dcos=False, mm=mm), iters=5),
        time_ms(lambda: d_library(*lb), iters=5), nbytes, flops,
        peak_flops=PEAK_BF16_FLOPS, role="learn", rel_frobenius_err=max(fros),
        te_branch_flips=int((mask.bool() != (
            cos2.to(mm).float() @ we.to(mm).float() + be > 0)).sum()),
        bit_identical_repeat=True, groups=iqn_head.bf16_groups_d(b, s),
        ms_with_staging=time_ms(lambda: iqn_head.iqn_head_bwd_d(
            *d_args, need_dcos=False, mm=mm), iters=5),
        with_dcos_ms=time_ms(lambda: iqn_head.iqn_head_bwd_d(
            *d_args, mm=mm, staged=st), iters=5))
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
  first = None
  for i in range(warm):
    state = engine.superstep(state)
    if first is None and state.telemetry.learn_steps:
      first = i
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
  for name in PATH_KERNELS["dqn"]:
    if counts[name] == 0:
      fail(f"kernel {name} was not launched on the dqn main path")
  if m.replay_size < engine.spec.min_replay_capacity_fraction * \
      cfg.replay_capacity:
    fail("replay below its min fill after learning")
  if int(estate.env_frames) <= 0:
    fail("eval ran no frames")

  # Outputs: Q-values of the current observations through the kernels are
  # finite, of shape (128, 6), and agree with the plain torso.
  q_err = _dqn_q_against_plain(engine.network, state.online_params,
                               state.stack.frames)

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
      first_learning_superstep=first, q_max_abs_err=q_err,
      peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
  MAIN_READINGS.update(
      first_learning_superstep=first,
      ms_per_superstep=summary["ms_per_superstep"],
      env_steps_per_s=summary["env_steps_per_s"],
      host_ms_per_other_superstep=summary["host_ms_per_other_superstep"])
  print("MAIN " + json.dumps(summary), flush=True)

  # Three learning supersteps under the profiler (after the counts were
  # read: they are not the path's).
  def supersteps():
    nonlocal state
    for _ in range(3):
      state = engine.superstep(state)
  traced_window("MAIN", supersteps, PATH_KERNELS["dqn"])
  return counts


def bf16_layers_against_cpu(params, cpu_params, obs):
  """The bf16 DQN network's five layers chained on `params`' device, each
  also computed on the CPU and in f32 on that device from the same input:
  {layer: (relative Frobenius of its bf16 pre-activation against the CPU's,
  the f32 layer's against the same)} and the chain's q."""
  from dqn_zoo_torch.nets import core

  def linear(x, w, b, compute_dtype):
    return core.linear(x, {"w": w, "b": b}, compute_dtype)

  layers = [(params["torso"][name], cpu_params["torso"][name],
             name, functools.partial(core.conv2d, stride=stride))
            for name, stride in (("conv1", 4), ("conv2", 2), ("conv3", 1))]
  layers += [(params["head"][name], cpu_params["head"][name], name, linear)
             for name in ("hidden", "out")]
  errs = {}
  h = obs.to(torch.float32) * (1.0 / 255.0)
  for p, p_cpu, name, layer in layers:
    if name == "hidden":
      h = core.flatten(h)
    y = layer(h, p["w"], p["b"], compute_dtype=torch.bfloat16)
    y_cpu = layer(h.cpu(), p_cpu["w"], p_cpu["b"],
                  compute_dtype=torch.bfloat16)
    y_f32 = layer(h, p["w"], p["b"], compute_dtype=torch.float32)
    errs[name] = (rel_frobenius(y.cpu(), y_cpu),
                  rel_frobenius(y_f32.cpu(), y_cpu))
    h = y if name == "out" else core.relu(y)
  return errs, h


def phase_bf16_path(dev):
  """BF16_MAIN: dqn/pong at the CLI defaults with compute_dtype=bfloat16
  through the user's entry points. The torso is the cast convolutions
  (cuDNN), as the reference's K3 computes in f32 only: K1 and K2 launch
  once a learning superstep, K3a and K3b never. 20 warm, 100 timed and 20
  fenced supersteps; the Q-values against the same bf16 network on the
  CPU; returns the launch counts."""
  from dqn_zoo_torch import kernels
  from dqn_zoo_torch.run.train import build_engine

  engine = build_engine("dqn", "pong", num_envs=128,
                        replay_capacity=1_000_000,
                        min_replay_capacity_fraction=0.002,
                        spec_overrides=dict(compute_dtype="bfloat16"),
                        device="cuda")
  cfg = engine.config
  if (cfg.batch_size, cfg.learn_every, cfg.updates_per_learn) != (1024, 1, 1) \
      or engine.network.compute_dtype != torch.bfloat16:
    fail(f"unexpected bf16 engine {cfg}")
  state = engine.init(seed=1)
  kernels.reset_counts()
  warm, timed, fenced = 20, 100, 20
  state = engine.run(state, warm)
  torch.cuda.synchronize()
  steps_before = state.telemetry.learn_steps
  counts_before = kernels.counts()
  t0 = time.perf_counter()
  state = engine.run(state, timed)
  torch.cuda.synchronize()
  t_run = time.perf_counter() - t0
  counts_after = kernels.counts()
  if state.telemetry.learn_steps - steps_before != timed:
    fail(f"{state.telemetry.learn_steps - steps_before} bf16 learn steps in "
         f"{timed} timed supersteps")
  per_learning_superstep = {
      k: (counts_after[k] - counts_before[k]) / timed for k in counts_after}
  want = {k: 0 for k in counts_after}
  want.update({k: 1 for k in PATH_KERNELS["bf16"]})
  if per_learning_superstep != want:
    fail(f"launches per bf16 learning superstep {per_learning_superstep}, "
         f"expected {want}")
  split = {}
  state = engine.run(state, fenced, timings=split)
  torch.cuda.synchronize()
  counts = kernels.counts()
  m = engine.metrics(state)
  if m.learn_steps < 20 or not math.isfinite(m.last_loss):
    fail(f"bf16: {m.learn_steps} learn steps, loss {m.last_loss}")

  # Q-values of the current observations: finite, (128, 6), and those of
  # the same bf16 network on the CPU within 1e-3 relative Frobenius. Card
  # and CPU multiply the same bf16 operands exactly and sum in other
  # orders, so a layer's f32 output may differ in its last bits and round
  # to a neighbouring bf16 operand of the next layer; such flips carry on
  # to q, by a share of the f32 network's distance that depends on the
  # trained weights and the frames. Whether the card computes in bf16 is
  # therefore held layer by layer, where no flip carries: each layer's
  # pre-activation on the card's input of that layer, card against CPU,
  # within 1e-5 and under a hundredth of the f32 layer's distance; and the
  # layers chained on the card give the network's q bit for bit.
  from dqn_zoo_torch.nets import dqn_atari_network
  from dqn_zoo_torch.utils.pytree import tree_map
  obs = state.stack.frames
  with torch.no_grad():
    q = engine.network.apply(state.online_params, obs).q_values
    cpu_params = tree_map(lambda t: t.detach().cpu(), state.online_params)
    plain = engine.network.apply(cpu_params, obs.cpu()).q_values
    f32 = dqn_atari_network(6).apply(state.online_params, obs).q_values
    layer_errs, chained = bf16_layers_against_cpu(
        state.online_params, cpu_params, obs)
  if tuple(q.shape) != (128, 6) or not bool(torch.isfinite(q).all()):
    fail(f"bad bf16 Q-values {tuple(q.shape)}")
  q_err = rel_frobenius(q.cpu(), plain)
  f32_err = rel_frobenius(f32.cpu(), plain)
  if not q_err <= 1e-3:
    fail(f"bf16 Q-values against the CPU: {q_err} (the f32 net: {f32_err})")
  if not all(e <= 1e-5 and e < 0.01 * e32 for e, e32 in layer_errs.values()):
    fail(f"bf16 layers against the CPU (bf16, f32): {layer_errs}")
  if not torch.equal(chained, q):
    fail(f"the bf16 layers chained give q {rel_frobenius(chained, q)} off "
         "the network's")

  agent_steps = timed * cfg.num_envs
  summary = dict(
      supersteps=warm + timed + fenced, learn_steps=m.learn_steps,
      last_loss=m.last_loss, timed_supersteps=timed,
      ms_per_superstep=1e3 * t_run / timed,
      training_env_steps_per_s=agent_steps / t_run,
      main_ms_per_superstep=MAIN_READINGS.get("ms_per_superstep"),
      main_env_steps_per_s=MAIN_READINGS.get("env_steps_per_s"),
      split_ms_per_superstep={k: 1e3 * v / fenced for k, v in split.items()},
      launches_per_learning_superstep=per_learning_superstep,
      q_rel_frobenius_err_vs_cpu=q_err,
      f32_net_rel_frobenius_err_vs_cpu=f32_err,
      layer_rel_frobenius_err_vs_cpu_bf16_f32=layer_errs,
      peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, card=card())
  print("BF16_MAIN " + json.dumps(summary), flush=True)
  return counts


def phase_per_path(dev):
  """The port's prioritized/pong trainer at the CLI defaults (128 envs,
  replay 1e6, throughput batch 1024, one learn step per superstep) through
  the user's entry points, with MAIN's lowered min fill; checks what
  prioritized replay must show after learning and returns the launch
  counts."""
  from dqn_zoo_torch import kernels
  from dqn_zoo_torch.nets import atari, torso_cuda
  from dqn_zoo_torch.replay import device_replay as dr
  from dqn_zoo_torch.replay import fanout_tree as ft
  from dqn_zoo_torch.run.train import build_engine

  engine = build_engine("prioritized", "pong", num_envs=128,
                        replay_capacity=1_000_000,
                        min_replay_capacity_fraction=0.002, device="cuda")
  cfg, rcfg = engine.config, engine.rcfg
  if (cfg.batch_size, cfg.learn_every, cfg.updates_per_learn) != (1024, 1, 1) \
      or (rcfg.priority_exponent, rcfg.uniform_sample_probability,
          rcfg.normalize_weights_chunk) != (0.6, 1e-3, 32):
    fail(f"unexpected prioritized schedule {cfg} or replay {rcfg}")
  state = engine.init(seed=5)
  torch.cuda.synchronize()
  print(f"PER_MAIN engine built: replay {cfg.num_envs}x"
        f"{cfg.slots_per_stream} rows, two trees of "
        f"{state.replay.value_tree[0].numel()} leaves", flush=True)

  kernels.reset_counts()
  warm = 20  # the learn gate opens at ~2000 active rows (superstep ~18)
  state = engine.run(state, warm)
  torch.cuda.synchronize()
  timed = 300
  steps_before = state.telemetry.learn_steps
  counts_before = kernels.counts()
  resets = []
  t0 = time.perf_counter()
  for _ in range(timed):
    resets.append(state.env.needs_reset.any())
    state = engine.superstep(state)
  torch.cuda.synchronize()
  t_run = time.perf_counter() - t0
  counts_after = kernels.counts()
  if state.telemetry.learn_steps - steps_before != timed:
    fail(f"{state.telemetry.learn_steps - steps_before} prioritized learn "
         f"steps in {timed} timed supersteps")
  per_learning_superstep = {
      k: (counts_after[k] - counts_before[k]) / timed for k in counts_after
      if k in PATH_KERNELS["prioritized"]}
  # act, target and the double-Q selector on K3a; the online net on K3b.
  want = {"gather_windows": 1, "pooled_frame_to_84": 1, "dqn_torso_fwd": 3,
          "dqn_torso_fwd_residuals": 1}
  if per_learning_superstep != want:
    fail(f"launches per prioritized learning superstep "
         f"{per_learning_superstep}, expected {want}")
  split = {}
  fenced = 40
  state = engine.run(state, fenced, timings=split)
  torch.cuda.synchronize()
  counts = kernels.counts()

  m = engine.metrics(state)
  rep = state.replay
  if m.learn_steps < 20 or not math.isfinite(m.last_loss):
    fail(f"prioritized: {m.learn_steps} learn steps, loss {m.last_loss}")
  for name in PATH_KERNELS["prioritized"]:
    if counts[name] == 0:
      fail(f"kernel {name} was not launched on the prioritized main path")
  # Priorities: learning wrote |td|^α over the insert value, the max seen
  # moved off its start of 1, and the tree's sums hold its leaves.
  alpha = rcfg.priority_exponent
  max_seen = float(rep.max_seen_priority)
  n_active = float(ft.fanout_total(rep.indicator_tree))
  total = float(ft.fanout_total(rep.value_tree))
  leaf_sum = float(rep.value_tree[0].double().sum())
  if max_seen == 1.0 or not math.isfinite(max_seen):
    fail(f"max_seen_priority did not move: {max_seen}")
  if math.isclose(total, n_active * max_seen ** alpha, rel_tol=1e-6):
    fail(f"value tree total {total} is still count x max_seen^alpha")
  if not math.isclose(total, leaf_sum, rel_tol=1e-4):
    fail(f"value tree total {total} against its leaves' sum {leaf_sum}")
  # IS weights of a fresh throughput batch at this run's exponent: in
  # (0, 1], max 1 in every chunk of the agent's batch (32).
  beta = engine.importance_sampling_exponent(rep.t * cfg.num_envs)
  u = torch.rand((3, cfg.batch_size), generator=state.generator, device=dev)
  _, sampled, weights = dr.replay_sample(rcfg, rep, u, beta)
  chunks = weights.view(-1, rcfg.normalize_weights_chunk)
  if not (bool((weights > 0).all()) and bool((weights <= 1).all())
          and bool((chunks.max(dim=1).values == 1).all())):
    fail(f"IS weights out of (0, 1] or without max 1 per chunk: "
         f"{weights.min().item()} .. {weights.max().item()}")
  repeats = cfg.batch_size - int(torch.unique(sampled).numel())

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
    fail(f"bad prioritized Q-values {tuple(q.shape)}")
  torch.testing.assert_close(q, plain, rtol=1e-4, atol=1e-5)

  # Where the replay's share of the learn stage goes: eager wall-clock ms
  # per call (host and device together, the stream drained at the end) of
  # a prioritized sample, the uniform sample on the same rows, and the
  # priority write (last, since it changes the tree).
  def wall_ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(reps):
      fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t1) / reps

  uniform_cfg = dataclasses.replace(rcfg, priority_exponent=0.0)
  replay_ms = dict(
      sample_prioritized=wall_ms(lambda: dr.replay_sample(rcfg, rep, u,
                                                          beta)),
      sample_uniform=wall_ms(lambda: dr.replay_sample(uniform_cfg, rep,
                                                      u[0])),
      update_priorities=wall_ms(lambda: dr.replay_update_priorities(
          rcfg, rep, sampled, weights)))

  summary = dict(
      supersteps=warm + timed + fenced, learn_steps=m.learn_steps,
      last_loss=m.last_loss, replay_size=m.replay_size,
      env_frames=m.env_frames, timed_supersteps=timed,
      training_env_steps_per_s=timed * cfg.num_envs / t_run,
      ms_per_learning_superstep=1e3 * t_run / timed,
      reset_supersteps_in_timed=int(torch.stack(resets).sum()),
      split_ms_per_superstep={k: 1e3 * v / fenced for k, v in split.items()},
      launches_per_learning_superstep=per_learning_superstep,
      max_seen_priority=max_seen, value_tree_total=total,
      active_rows=n_active, insert_value=max_seen ** alpha,
      is_exponent=beta, is_weight_min=float(weights.min()),
      is_weight_mean=float(weights.mean()),
      repeated_leaves_in_a_batch=repeats, replay_ms_per_call=replay_ms,
      train_launches=counts,
      q_max_abs_err=float((q - plain).abs().max()),
      peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
  print("PER_MAIN " + json.dumps(summary), flush=True)
  return counts


def card() -> str:
  """The card's name and power limit, as nvidia-smi gives them."""
  smi = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit",
       "--format=csv,noheader"], capture_output=True, text=True, check=True)
  return smi.stdout.strip().splitlines()[0]


def phase_rainbow_path(dev, game: str = "pong", timed: int = 300,
                       fenced: int = 40, eval_supersteps: int = 0):
  """The port's rainbow trainer on `game` at the CLI defaults (128 envs,
  replay 1e6, throughput batch 1024, n-step 3 under prioritized replay,
  noisy dueling C51 net, clip + Adam) through the user's entry points, with
  MAIN's lowered min fill: 24 warm supersteps, `timed` timed and `fenced`
  fenced learning ones, then an eval chunk of `eval_supersteps` on 4 envs;
  checks the loss, the priorities, the outputs and the launches per
  learning superstep, and returns the launch counts."""
  import shutil
  from dqn_zoo_torch import kernels
  from dqn_zoo_torch.agents.base import ClipByGlobalNorm
  from dqn_zoo_torch.engine.superstep import leaves
  from dqn_zoo_torch.nets import atari, core, torso_cuda
  from dqn_zoo_torch.replay import device_replay as dr
  from dqn_zoo_torch.run import checkpoint as ckpt
  from dqn_zoo_torch.run.train import build_engine, save_checkpoint

  path = "rainbow" if game == "pong" else f"rainbow_{game}"
  tag = path.upper() + "_MAIN"
  engine = build_engine("rainbow", game, num_envs=128,
                        replay_capacity=1_000_000,
                        min_replay_capacity_fraction=0.002, device="cuda")
  cfg, rcfg, spec = engine.config, engine.rcfg, engine.spec
  if (cfg.batch_size, cfg.learn_every, cfg.updates_per_learn) != (1024, 1, 1) \
      or (rcfg.n_step, rcfg.window, rcfg.priority_exponent,
          rcfg.uniform_sample_probability, rcfg.normalize_weights_chunk) != \
      (3, 7, 0.5, 1e-3, 32) or (spec.num_atoms, spec.vmax) != (51, 10.0) \
      or not isinstance(engine.optimizer, ClipByGlobalNorm) \
      or not math.isclose(spec.learning_rate, 6.25e-5 * 32 ** 0.5):
    fail(f"unexpected rainbow schedule {cfg}, replay {rcfg} or spec {spec}")
  state = engine.init(seed=7)
  torch.cuda.synchronize()
  n_params = sum(p.numel() for p in leaves(state.online_params))
  print(f"{tag} engine built: replay {cfg.num_envs}x"
        f"{cfg.slots_per_stream} rows, {n_params} parameters", flush=True)

  kernels.reset_counts()
  # The learn gate opens at ~2000 active rows; a row waits n = 3 steps for
  # its return, so learning starts a few supersteps after MAIN's ~18.
  warm = 24
  state = engine.run(state, warm)
  torch.cuda.synchronize()
  if state.telemetry.learn_steps == 0:
    fail(f"{path} took no learn step in {warm} supersteps")
  steps_before = state.telemetry.learn_steps
  counts_before = kernels.counts()
  resets = []
  t0 = time.perf_counter()
  for _ in range(timed):
    resets.append(state.env.needs_reset.any())
    state = engine.superstep(state)
  torch.cuda.synchronize()
  t_run = time.perf_counter() - t0
  counts_after = kernels.counts()
  if state.telemetry.learn_steps - steps_before != timed:
    fail(f"{state.telemetry.learn_steps - steps_before} {path} learn steps "
         f"in {timed} timed supersteps")
  per_learning_superstep = {
      k: (counts_after[k] - counts_before[k]) / timed for k in counts_after
      if k in PATH_KERNELS[path]}
  # act, the double-Q selector and the target net on K3a; the online net
  # on K3b; one window gather of W = 7 rows per sample.
  want = {"gather_windows": 1, "pooled_frame_to_84": 1, "dqn_torso_fwd": 3,
          "dqn_torso_fwd_residuals": 1}
  if per_learning_superstep != want:
    fail(f"launches per {path} learning superstep "
         f"{per_learning_superstep}, expected {want}")
  split = {}
  fenced_resets = []
  for _ in range(fenced):
    fenced_resets.append(state.env.needs_reset.any())
    state = engine.superstep(state, timings=split)
  torch.cuda.synchronize()
  train_counts = kernels.counts()
  eval_ms = eval_frames = None
  if eval_supersteps:
    estate = engine.eval_init(seed=8, num_envs=4)
    t0 = time.perf_counter()
    estate = engine.eval_run(state.online_params, estate, eval_supersteps)
    torch.cuda.synchronize()
    eval_ms = 1e3 * (time.perf_counter() - t0) / eval_supersteps
    eval_frames = int(estate.env_frames)
    if eval_frames <= 0:
      fail(f"{path} eval ran no frames")
  counts = kernels.counts()

  m = engine.metrics(state)
  rep = state.replay
  if m.learn_steps < 20 or not math.isfinite(m.last_loss):
    fail(f"{path}: {m.learn_steps} learn steps, loss {m.last_loss}")
  for name in PATH_KERNELS[path]:
    if counts[name] == 0:
      fail(f"kernel {name} was not launched on the {path} main path")
  # Priorities are clip(|loss|, 0, 100): the leaves written (priority^0.5)
  # lie in [0, 10] and the max seen is finite, at most 100.
  max_seen = float(rep.max_seen_priority)
  leaf_max = float(rep.value_tree[0].max())
  leaf_min = float(rep.value_tree[0].min())
  if not (math.isfinite(max_seen) and 0 < max_seen <= 100.0) or \
      max_seen == 1.0 or not 0.0 <= leaf_min <= leaf_max <= 10.0:
    fail(f"{path} priorities out of range: max seen {max_seen}, leaves "
         f"{leaf_min} .. {leaf_max}")
  # The priorities of a fresh batch (through the kernels, after the counts
  # were read) lie in [0, 100].
  draws = engine.draw(state.generator)
  batch, _, weights = dr.replay_sample(
      rcfg, rep, draws.sample_u[0],
      engine.importance_sampling_exponent(rep.t * cfg.num_envs))
  with torch.no_grad():
    out = spec.loss(spec, engine.network, state.online_params,
                    state.target_params, batch, weights,
                    *(type(n)(*(x[0] for x in n)) for n in draws.loss_noise))
  prio = out.priorities
  if not (bool(torch.isfinite(prio).all()) and float(prio.min()) >= 0.0
          and float(prio.max()) <= 100.0 and math.isfinite(float(out.loss))):
    fail(f"{path} priorities of a fresh batch out of [0, 100]: "
         f"{float(prio.min())} .. {float(prio.max())}")

  # Outputs: the current observations through the kernels, against the
  # plain torso under the same noise.
  a = engine.game.num_actions
  with torch.no_grad():
    obs = state.stack.frames
    noise = engine.network.draw_noise(state.generator, dev)
    got = engine.network.apply(state.online_params, obs, noise)
    t = state.online_params["torso"]
    plain_torso = torso_cuda.torso_plain(
        t["conv1"]["w"], t["conv1"]["b"], t["conv2"]["w"], t["conv2"]["b"],
        t["conv3"]["w"], t["conv3"]["b"], obs)
    p = state.online_params
    adv = core.noisy_linear(torch.relu(core.noisy_linear(
        plain_torso, p["advantage"]["hidden"], *noise[:2])),
        p["advantage"]["out"], *noise[2:4]).reshape(-1, a, spec.num_atoms)
    val = core.noisy_linear(torch.relu(core.noisy_linear(
        plain_torso, p["value"]["hidden"], *noise[4:6])),
        p["value"]["out"], *noise[6:]).reshape(-1, 1, spec.num_atoms)
    plain_logits = val + adv - adv.mean(dim=1, keepdim=True)
    plain_q = (torch.softmax(plain_logits, -1)
               * engine.network.support(dev)).sum(-1)
  if tuple(got.q_logits.shape) != (cfg.num_envs, a, spec.num_atoms) or \
      tuple(got.q_values.shape) != (cfg.num_envs, a) or \
      not bool(torch.isfinite(got.q_logits).all()) or \
      float(got.q_values.abs().max()) > spec.vmax:
    fail(f"bad {path} outputs {tuple(got.q_logits.shape)}")
  torch.testing.assert_close(got.q_logits, plain_logits, rtol=1e-4, atol=1e-5)
  torch.testing.assert_close(got.q_values, plain_q, rtol=1e-4, atol=1e-5)

  # The replay-less checkpoint a chain of legs carries between calls.
  root = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".ckpt",
                      f"chip_smoke_{path}")
  shutil.rmtree(root, ignore_errors=True)
  lite = ckpt.TorchCheckpoint(root)
  save_checkpoint(lite, state, 1, {}, 0, checkpoint_replay=False)
  replayless_bytes = os.path.getsize(lite.state_path())
  shutil.rmtree(root, ignore_errors=True)

  summary = dict(
      supersteps=warm + timed + fenced, learn_steps=m.learn_steps,
      last_loss=m.last_loss, replay_size=m.replay_size,
      env_frames=m.env_frames, timed_supersteps=timed,
      training_env_steps_per_s=timed * cfg.num_envs / t_run,
      ms_per_learning_superstep=1e3 * t_run / timed,
      reset_supersteps_in_timed=int(torch.stack(resets).sum()),
      split_ms_per_superstep={k: 1e3 * v / fenced for k, v in split.items()},
      reset_supersteps_in_fenced=int(torch.stack(fenced_resets).sum()),
      launches_per_learning_superstep=per_learning_superstep,
      parameters=n_params, max_seen_priority=max_seen,
      value_leaf_range=[leaf_min, leaf_max],
      fresh_batch_priority_range=[float(prio.min()), float(prio.max())],
      fresh_batch_loss=float(out.loss), train_launches=train_counts,
      eval_supersteps=eval_supersteps, eval_frames=eval_frames,
      eval_ms_per_superstep=eval_ms,
      eval_launches={k: counts[k] - train_counts[k] for k in counts},
      q_logits_max_abs_err=float((got.q_logits - plain_logits).abs().max()),
      replayless_checkpoint_bytes=replayless_bytes,
      replayless_checkpoint_fits_64mib=replayless_bytes <= 64 * 2**20,
      peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, card=card())
  print(f"{tag} " + json.dumps(summary), flush=True)
  return counts


def _to_device(tree, dev):
  """A NamedTuple of tensors (nested; None for a game that draws nothing)
  copied to `dev`."""
  if tree is None or isinstance(tree, torch.Tensor):
    return None if tree is None else tree.to(dev)
  return type(tree)(*(_to_device(x, dev) for x in tree))


def _hold_game(dev, name: str, groups: int, seed: int, cap=None,
               count=None):
  """The port's vector `name` at B=128 on the card and on the CPU for
  `groups` groups from the same draws (noop burns, per-frame draws where
  the game takes them) and the same actions, made on the CPU; every output
  (frames, rewards, lives, ...) and every state field must agree bit for
  bit. `cap` is the episode frame cap; `count(state before, state after,
  output)` adds up a game event on the CPU's side. Returns the reset groups
  after the first, the events and ms a group on the card and on the
  CPU."""
  from dqn_zoo_torch.envs.api import get_game
  from dqn_zoo_torch.envs.vector import VectorAtariEnv, VectorEnvConfig

  b = 128
  tag = name.upper()
  game = get_game(name)
  cfg = VectorEnvConfig() if cap is None else VectorEnvConfig(
      episode_frame_cap=cap)
  envs = {d: VectorAtariEnv(game, b, cfg, device=d) for d in ("cpu", dev)}
  gen = torch.Generator().manual_seed(seed)
  cpu_state = envs["cpu"].init(gen)
  card_state = _to_device(cpu_state, dev)
  resets = events = 0
  t_cpu = t_card = 0.0
  for g in range(groups):
    draws = envs["cpu"].draws(gen)
    actions = torch.randint(0, game.num_actions, (b,), generator=gen)
    before = cpu_state
    resets += g > 0 and bool(cpu_state.needs_reset.any())
    t0 = time.perf_counter()
    cpu_state, cpu_out = envs["cpu"].step(cpu_state, actions, draws)
    t1 = time.perf_counter()
    card_state, card_out = envs[dev].step(
        card_state, actions.to(dev), _to_device(draws, dev))
    torch.cuda.synchronize()
    t_cpu += t1 - t0
    t_card += time.perf_counter() - t1
    for field, a, w in zip(cpu_out._fields, card_out, cpu_out):
      if not torch.equal(a.cpu(), w):
        fail(f"{tag}: output {field} differs between the card and the CPU "
             f"at group {g}")
    for field, a, w in zip(cpu_state.game_state._fields,
                           card_state.game_state, cpu_state.game_state):
      if not torch.equal(a.cpu(), w):
        fail(f"{tag}: state field {field} differs at group {g}")
    for field in ("episode_frames", "needs_reset"):
      if not torch.equal(getattr(card_state, field).cpu(),
                         getattr(cpu_state, field)):
        fail(f"{tag}: {field} differs at group {g}")
    if count is not None:
      events += count(before, cpu_state, cpu_out)
  return dict(envs=b, groups=groups, bit_identical=True, reset_groups=resets,
              events=events, card_ms_per_group=1e3 * t_card / groups,
              cpu_ms_per_group=1e3 * t_cpu / groups)


def check_seaquest(dev):
  """SEAQUEST: 64 groups of the port's vector seaquest at B=128 held card
  against CPU (`_hold_game`), diver spawns from the per-frame draws
  counted."""
  spawns = lambda a, b, out: int((b.game_state.diver_live
                                  & ~a.game_state.diver_live).sum())
  line = _hold_game(dev, "seaquest", 64, 9, count=spawns)
  line["diver_spawns"] = line.pop("events")
  if line["reset_groups"] < 1 or line["diver_spawns"] == 0:
    fail(f"SEAQUEST: {line['reset_groups']} reset groups and "
         f"{line['diver_spawns']} diver spawns in 64 groups")
  print("SEAQUEST " + json.dumps(line), flush=True)


def check_games(dev):
  """GAMES: 32 groups of each of NEW_GAMES at B=128 held card against CPU
  (`_hold_game`) under a 48-frame episode cap, so that every game runs
  its reset branch (the noop burn) after the first group; the env groups
  with a nonzero reward are counted."""
  rewarded = lambda a, b, out: int((out.raw_reward_sum != 0).sum())
  lines = {}
  for i, name in enumerate(NEW_GAMES):
    line = _hold_game(dev, name, 32, 20 + i, cap=48, count=rewarded)
    line["rewarded_env_groups"] = line.pop("events")
    if line["reset_groups"] < 1:
      fail(f"GAMES: {name} ran no reset group after the first")
    lines[name] = line
  print("GAMES " + json.dumps(lines), flush=True)


def check_pil(dev):
  """PIL, its kernel-free steps: the exact Pillow resize on the card
  reproduces tests/test_pil_resize.py's golden digest from the same
  RandomState(42) image, and 128 pooled breakout frames (a group of the
  vector env at 128 envs after 12 groups of random play) give the same
  observations at `pil` on the card and on the CPU."""
  import hashlib
  import numpy as np
  from dqn_zoo_torch.envs.api import get_game
  from dqn_zoo_torch.envs.vector import VectorAtariEnv
  from dqn_zoo_torch.prep import atari as tprep
  from dqn_zoo_torch.prep.pil_resize import resize_pil_exact

  img = np.random.RandomState(42).randint(0, 256, (210, 160), np.uint8)
  got = resize_pil_exact(torch.from_numpy(img).to(dev)).cpu().numpy()
  digest = hashlib.sha256(got.tobytes()).hexdigest()
  if digest != GOLDEN_RESIZE_DIGEST:
    fail(f"PIL: the card's resize hashes to {digest}, not the golden digest")

  game = get_game("breakout")
  env = VectorAtariEnv(game, 128, device="cpu")
  gen = torch.Generator().manual_seed(5)
  state = env.init(gen)
  for _ in range(12):
    actions = torch.randint(0, game.num_actions, (128,), generator=gen)
    state, out = env.step(state, actions, env.draws(gen))
  frames = (out.frame_penult, out.frame_last)
  want = tprep.pooled_frame_to_84(*frames, "pil")
  on_card = [f.to(dev) for f in frames]
  got = tprep.pooled_frame_to_84(*on_card, "pil")
  if not torch.equal(got.cpu(), want):
    fail(f"PIL: {int((got.cpu() != want).sum())} of {want.numel()} pixels "
         f"differ between the card and the CPU")
  ms = time_ms(lambda: tprep.pooled_frame_to_84(*on_card, "pil"))
  print("PIL " + json.dumps(dict(
      golden_digest=digest == GOLDEN_RESIZE_DIGEST, frames=128,
      bit_identical=True, card_ms_per_call=ms, card=card())),
      flush=True)


def phase_pil_path(dev):
  """PIL_MAIN: the dqn/pong trainer at `--resize_method=pil` at MAIN's
  shapes and lowered min fill, 40 supersteps (20 of them learning ones);
  the prep stage is max, luma and the exact resize, so K2 must not launch
  and K1, K3a (act and target) and K3b must, once, twice and once a
  learning superstep. Returns the launch counts."""
  from dqn_zoo_torch import kernels
  from dqn_zoo_torch.run.train import build_engine

  engine = build_engine("dqn", "pong", num_envs=128,
                        replay_capacity=1_000_000,
                        min_replay_capacity_fraction=0.002,
                        resize_method="pil", device="cuda")
  if engine.config.resize_method != "pil":
    fail(f"unexpected resize method {engine.config.resize_method}")
  state = engine.init(seed=3)
  kernels.reset_counts()
  state = engine.run(state, 20)
  torch.cuda.synchronize()
  if state.telemetry.learn_steps == 0:
    fail("PIL_MAIN took no learn step in 20 supersteps")
  before = kernels.counts()
  t0 = time.perf_counter()
  state = engine.run(state, 20)
  torch.cuda.synchronize()
  t_run = time.perf_counter() - t0
  counts = kernels.counts()
  per = {k: (counts[k] - before[k]) / 20 for k in counts
         if k in PATH_KERNELS["dqn"]}
  want = {"gather_windows": 1, "pooled_frame_to_84": 0, "dqn_torso_fwd": 2,
          "dqn_torso_fwd_residuals": 1}
  if per != want:
    fail(f"launches per PIL_MAIN learning superstep {per}, expected {want}")
  m = engine.metrics(state)
  if m.learn_steps < 20 or not math.isfinite(m.last_loss):
    fail(f"PIL_MAIN: {m.learn_steps} learn steps, loss {m.last_loss}")
  if counts["pooled_frame_to_84"]:
    fail("PIL_MAIN launched K2")
  print("PIL_MAIN " + json.dumps(dict(
      supersteps=40, learn_steps=m.learn_steps, last_loss=m.last_loss,
      launches_per_learning_superstep=per, train_launches=counts,
      ms_per_learning_superstep=1e3 * t_run / 20,
      training_env_steps_per_s=20 * 128 / t_run, card=card())),
      flush=True)
  return counts


def _dqn_q_against_plain(network, params, obs) -> float:
  """The DQN net's Q-values of `obs` through the kernels against the plain
  torso and the same head (rtol 1e-4, atol 1e-5); returns the largest
  difference."""
  from dqn_zoo_torch.nets import atari, torso_cuda
  with torch.no_grad():
    q = network.apply(params, obs).q_values
    t = params["torso"]
    plain = atari.dqn_value_head(params["head"], torso_cuda.torso_plain(
        t["conv1"]["w"], t["conv1"]["b"], t["conv2"]["w"], t["conv2"]["b"],
        t["conv3"]["w"], t["conv3"]["b"], obs))
  if tuple(q.shape) != (obs.shape[0], 6) or not bool(torch.isfinite(q).all()):
    fail(f"bad Q-values {tuple(q.shape)}")
  torch.testing.assert_close(q, plain, rtol=1e-4, atol=1e-5)
  return float((q - plain).abs().max())


# Each hand-written kernel's name in a profiler trace (K3a and K3b are the
# two instantiations of one template).
TRACE_NAMES = {
    "gather_windows": ("gather_windows_kernel",),
    "pooled_frame_to_84": ("pooled_frame_to_84_kernel",),
    "dqn_torso_fwd": ("dqn_torso_kernel<false>", "dqn_torso_kernel<(bool)0>"),
    "dqn_torso_fwd_residuals": ("dqn_torso_kernel<true>",
                                "dqn_torso_kernel<(bool)1>"),
}
DEVICE_EVENT_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _busy_ms(intervals, w0: float, w1: float) -> float:
  """The length of the union of (start, end) intervals clipped to
  [w0, w1], in the trace's µs, as ms."""
  busy, end = 0.0, w0
  for a, b in sorted(intervals):
    a, b = max(a, end), min(b, w1)
    if b > a:
      busy += b - a
      end = b
  return busy / 1e3


def traced_window(label: str, fn, expect) -> dict:
  """TRACE: runs `fn()` under profiling.trace (torch.profiler, CPU and
  CUDA activity) in a temporary directory, inside one record_function span
  that ends in a synchronize, then deletes the directory. Prints one TRACE
  line: the top ten device operations by device time (name, calls, ms),
  the device-busy share of the span (the union of kernel, copy and memset
  intervals over the span's wall time), the trace file's bytes, and the
  trace's events against the launch counters for each kernel of `expect`.
  Fails if the trace holds no CUDA kernel event or if a kernel of `expect`
  that the span launched has no event."""
  import shutil
  import tempfile
  from dqn_zoo_torch import kernels
  from dqn_zoo_torch.utils import profiling

  tmp = tempfile.mkdtemp(prefix="chip_smoke_trace_")
  try:
    before = kernels.counts()
    t0 = time.perf_counter()
    with profiling.trace(tmp) as prof:
      with torch.profiler.record_function("chip_smoke_window"):
        fn()
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launched = {k: v - before[k] for k, v in kernels.counts().items()}
    nbytes = os.path.getsize(prof.trace_path)
    with open(prof.trace_path) as f:
      events = json.load(f)["traceEvents"]
  finally:
    shutil.rmtree(tmp, ignore_errors=True)
  spans = [e for e in events if e.get("name") == "chip_smoke_window"
           and e.get("cat") == "user_annotation"]
  if len(spans) != 1:
    fail(f"TRACE {label}: {len(spans)} window spans in the trace")
  w0 = float(spans[0]["ts"])
  w1 = w0 + float(spans[0]["dur"])
  device = [e for e in events if e.get("cat") in DEVICE_EVENT_CATS
            and "dur" in e]
  kernel_events = [e for e in device if e["cat"] == "kernel"]
  if not kernel_events:
    fail(f"TRACE {label}: no CUDA kernel event in the trace (CUPTI gave "
         "no device activity)")
  by_name = {}
  for e in device:
    calls, us = by_name.get(e["name"], (0, 0.0))
    by_name[e["name"]] = (calls + 1, us + float(e["dur"]))
  top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
  hand_written = {}
  for k in expect:
    n = sum(1 for e in kernel_events
            if any(p in e["name"] for p in TRACE_NAMES[k]))
    hand_written[k] = dict(trace_events=n, launches=launched[k])
    if launched[k] and not n:
      fail(f"TRACE {label}: {k} launched {launched[k]} times in the window, "
           "but the trace has no event of it")
    if not launched[k]:
      fail(f"TRACE {label}: the window launched no {k}")
  busy = _busy_ms([(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in device], w0, w1)
  line = dict(
      window=label, window_ms=(w1 - w0) / 1e3,
      host_ms_with_profiler_and_export=1e3 * wall_s,
      device_busy_ms=busy, device_busy_share=busy / ((w1 - w0) / 1e3),
      kernel_events=len(kernel_events), device_events=len(device),
      trace_file_bytes=nbytes, hand_written=hand_written,
      top_device_ops=[dict(name=n[:100], calls=c, ms=us / 1e3)
                      for n, (c, us) in top],
      card=card())
  print("TRACE " + json.dumps(line), flush=True)
  return line


# What MAIN read that OVERLAP_MAIN is held against or printed beside.
MAIN_READINGS = {}
IQN_READINGS = {}


def phase_host_path(dev):
  """HOST_MAIN: the dqn/pong trainer over the C++ farm (HostEnvEngine over
  CppVectorEnv("pong", 128), the farm built from cpp/dz_env.cc) at MAIN's
  config: 128 envs, replay 1e6, throughput batch 1024, full-width Nature
  DQN, min fill 0.2 %. 20 warm, 200 timed and 40 fenced supersteps, then
  20 probe supersteps that time how long the farm stepped while the card
  still ran the half-step's learn block. Checks the loss, the Q-values
  against the plain torso, the uploaded observations against the farm's
  and the launches per learning superstep (K1 1, K2 0: the farm
  preprocesses on the host, K3a 2, K3b 1). Returns the launch counts."""
  import numpy as np
  from dqn_zoo_torch import kernels
  from dqn_zoo_torch.engine.host_env import HostEnvEngine
  from dqn_zoo_torch.envs import cpp_bridge
  from dqn_zoo_torch.run.train import build_engine

  farm_build_s = cpp_bridge.build_farm()
  config = build_engine("dqn", "pong", num_envs=128,
                        replay_capacity=1_000_000,
                        min_replay_capacity_fraction=0.002,
                        device="cuda").config
  env = cpp_bridge.CppVectorEnv("pong", config.num_envs, seed=5,
                                device="cuda")
  engine = HostEnvEngine(config, env, device="cuda")
  cfg = engine.config
  if (cfg.batch_size, cfg.learn_every, cfg.updates_per_learn,
      cfg.num_actions) != (1024, 1, 1, 6):
    fail(f"unexpected host-engine config {cfg}")
  state = engine.init(seed=1)
  torch.cuda.synchronize()

  kernels.reset_counts()
  warm = 20
  state = engine.run(state, warm)
  torch.cuda.synchronize()
  if state.telemetry.learn_steps == 0:
    fail(f"HOST_MAIN took no learn step in {warm} supersteps")
  timed = 200
  steps_before = state.telemetry.learn_steps
  counts_before = kernels.counts()
  t0 = time.perf_counter()
  state = engine.run(state, timed)
  torch.cuda.synchronize()
  t_run = time.perf_counter() - t0
  counts_after = kernels.counts()
  if state.telemetry.learn_steps - steps_before != timed:
    fail(f"{state.telemetry.learn_steps - steps_before} HOST_MAIN learn steps "
         f"in {timed} timed supersteps")
  per_learning_superstep = {
      k: (counts_after[k] - counts_before[k]) / timed for k in counts_after
      if k in PATH_KERNELS["dqn"]}
  want = {"gather_windows": 1, "pooled_frame_to_84": 0, "dqn_torso_fwd": 2,
          "dqn_torso_fwd_residuals": 1}
  if per_learning_superstep != want:
    fail(f"launches per HOST_MAIN learning superstep "
         f"{per_learning_superstep}, expected {want}")
  split = {}
  fenced = 40
  state = engine.run(state, fenced, timings=split)
  torch.cuda.synchronize()

  # The probe: the loop of `run`, with a CUDA event after each half-step
  # and one after the farm step that follows it. The device time between
  # them is how long the card sat idle before the farm returned, so
  # farm ms - that gap is how long the farm stepped while the card still
  # ran the half-step's work.
  probe = 20
  marks, farm_s, fed = [], [], []
  group = env.step(np.zeros((cfg.num_envs,), np.int32))
  for _ in range(probe):
    fed.append(torch.from_numpy(group.obs84.copy()))
    state, actions = engine.step(state, group)
    done = torch.cuda.Event(enable_timing=True)
    done.record()
    t1 = time.perf_counter()
    group = env.step(actions)
    farm_s.append(time.perf_counter() - t1)
    back = torch.cuda.Event(enable_timing=True)
    back.record()
    marks.append((done, back))
  torch.cuda.synchronize()
  counts = kernels.counts()
  gaps = [a.elapsed_time(b) for a, b in marks]
  overlap = [max(0.0, min(1e3 * f, 1e3 * f - g))
             for f, g in zip(farm_s, gaps)]
  # The rows the probe inserted are the observations the farm returned.
  c = engine.rcfg.slots_per_stream
  first = state.replay.t - probe
  for k, obs in enumerate(fed):
    if not torch.equal(state.replay.frames[:, (first + k) % c].cpu(), obs):
      fail(f"HOST_MAIN replay row {first + k} differs from the farm's group")

  m = engine.metrics(state)
  if m["learn_steps"] < 20 or not math.isfinite(m["last_loss"]):
    fail(f"HOST_MAIN: {m}")
  for name in PATH_KERNELS["host"]:
    if counts[name] == 0:
      fail(f"kernel {name} was not launched on the host-env path")
  if counts["pooled_frame_to_84"]:
    fail("HOST_MAIN launched K2")
  q_err = _dqn_q_against_plain(engine.network, state.online_params,
                               state.stack.frames)
  mean = lambda xs: sum(xs) / len(xs)
  env.close()
  print("HOST_MAIN " + json.dumps(dict(
      farm_build_s=farm_build_s, farm_threads=os.cpu_count(),
      supersteps=warm + timed + fenced + probe, **m,
      timed_supersteps=timed,
      training_env_steps_per_s=timed * cfg.num_envs / t_run,
      ms_per_superstep=1e3 * t_run / timed,
      split_ms_per_superstep={k: 1e3 * v / fenced for k, v in split.items()},
      probe_farm_ms=mean(farm_s) * 1e3, probe_card_idle_gap_ms=mean(gaps),
      probe_farm_ms_overlapping_learn=mean(overlap),
      launches_per_learning_superstep=per_learning_superstep,
      train_launches=counts, q_max_abs_err=q_err,
      peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, card=card())),
      flush=True)
  return counts


def phase_overlap_path(dev):
  """OVERLAP_MAIN: MAIN's dqn/pong trainer with overlap_env_learn=True
  (learn samples the replay before this superstep's insert, which follows
  the learn block). 20 warm, 40 timed and 20 fenced supersteps from MAIN's
  seed. Checks the loss, the Q-values, the launches per learning superstep
  (K1 1, K2 1, K3a 2, K3b 1) and that learning starts one superstep after
  MAIN's at the same min fill. Returns the launch counts."""
  from dqn_zoo_torch import kernels
  from dqn_zoo_torch.engine import Engine
  from dqn_zoo_torch.run.train import build_engine

  config = build_engine("dqn", "pong", num_envs=128,
                        replay_capacity=1_000_000,
                        min_replay_capacity_fraction=0.002,
                        device="cuda").config
  engine = Engine(dataclasses.replace(config, overlap_env_learn=True),
                  device="cuda")
  cfg = engine.config
  state = engine.init(seed=1)  # MAIN's
  kernels.reset_counts()
  warm = 20
  first = None
  for i in range(warm):
    state = engine.superstep(state)
    if first is None and state.telemetry.learn_steps:
      first = i
  main_first = MAIN_READINGS["first_learning_superstep"]
  if first is None or first != main_first + 1:
    fail(f"OVERLAP_MAIN learned first at superstep {first}, MAIN at "
         f"{main_first}")
  timed = 40
  before = kernels.counts()
  steps_before = state.telemetry.learn_steps
  t0 = time.perf_counter()
  state = engine.run(state, timed)
  torch.cuda.synchronize()
  t_run = time.perf_counter() - t0
  after = kernels.counts()
  if state.telemetry.learn_steps - steps_before != timed:
    fail(f"OVERLAP_MAIN took {state.telemetry.learn_steps - steps_before} "
         f"learn steps in {timed} timed supersteps")
  per = {k: (after[k] - before[k]) / timed for k in after
         if k in PATH_KERNELS["overlap"]}
  want = {"gather_windows": 1, "pooled_frame_to_84": 1, "dqn_torso_fwd": 2,
          "dqn_torso_fwd_residuals": 1}
  if per != want:
    fail(f"launches per OVERLAP_MAIN learning superstep {per}, "
         f"expected {want}")
  split = {}
  fenced = 20
  state = engine.run(state, fenced, timings=split)
  torch.cuda.synchronize()
  counts = kernels.counts()
  m = engine.metrics(state)
  if m.learn_steps < 20 or not math.isfinite(m.last_loss):
    fail(f"OVERLAP_MAIN: {m.learn_steps} learn steps, loss {m.last_loss}")
  if cfg.batch_size != 1024:
    fail(f"unexpected overlap config {cfg}")
  q_err = _dqn_q_against_plain(engine.network, state.online_params,
                               state.stack.frames)
  print("OVERLAP_MAIN " + json.dumps(dict(
      supersteps=warm + timed + fenced, learn_steps=m.learn_steps,
      last_loss=m.last_loss, first_learning_superstep=first,
      main_first_learning_superstep=main_first,
      timed_supersteps=timed, ms_per_superstep=1e3 * t_run / timed,
      main_ms_per_superstep=MAIN_READINGS["ms_per_superstep"],
      main_host_ms_per_other_superstep=MAIN_READINGS[
          "host_ms_per_other_superstep"],
      training_env_steps_per_s=timed * cfg.num_envs / t_run,
      split_ms_per_superstep={k: 1e3 * v / fenced for k, v in split.items()},
      launches_per_learning_superstep=per, train_launches=counts,
      q_max_abs_err=q_err,
      peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, card=card())),
      flush=True)
  return counts


def phase_learner_path(dev, name: str, game: str = "seaquest"):
  """The port's c51/seaquest or qrdqn/seaquest trainer (C51_MAIN,
  QRDQN_MAIN: 18 actions, 51 atoms on ±10 or 201 quantiles, clip + Adam) or
  its double_q/demon_attack trainer (DOUBLE_Q_MAIN: 6 actions, the
  shared-bias DQN head, centred RMSProp) at the CLI defaults (128 envs,
  replay 1e6, throughput batch 1024, uniform replay) through the user's
  entry points, with MAIN's lowered min fill: 20 warm, 40 timed and 20
  fenced learning supersteps, then one eval chunk. Checks the loss, the
  outputs against the plain torso and the launches per learning superstep
  (double_q's K3a three times: act, target and the double-Q selector),
  prints the timed supersteps that took the reset branch and the
  replay-less checkpoint's size against 64 MiB (the most a chain of
  training legs carries between runs), and returns the launch counts."""
  import shutil
  from dqn_zoo_torch import kernels
  from dqn_zoo_torch.agents.base import ClipByGlobalNorm
  from dqn_zoo_torch.engine.superstep import leaves
  from dqn_zoo_torch.nets import atari, torso_cuda
  from dqn_zoo_torch.run import checkpoint as ckpt
  from dqn_zoo_torch.run.train import build_engine, save_checkpoint

  tag = f"{name.upper()}_MAIN"
  engine = build_engine(name, game, num_envs=128,
                        replay_capacity=1_000_000,
                        min_replay_capacity_fraction=0.002, device="cuda")
  cfg, spec = engine.config, engine.spec
  a = engine.game.num_actions
  dist_shape = {"c51": (cfg.num_envs, a, 51),
                "qrdqn": (cfg.num_envs, 201, a)}.get(name)
  if (cfg.batch_size, cfg.learn_every, cfg.updates_per_learn) != (1024, 1, 1) \
      or a != {"seaquest": 18, "demon_attack": 6}[game] \
      or engine.rcfg.priority_exponent != 0.0 \
      or (name == "c51" and (spec.num_atoms, spec.vmax) != (51, 10.0)) \
      or (name == "qrdqn" and spec.num_quantiles != 201) \
      or isinstance(engine.optimizer, ClipByGlobalNorm) != (
          dist_shape is not None):
    fail(f"unexpected {name} schedule {cfg} or spec {spec}")
  state = engine.init(seed=11)
  torch.cuda.synchronize()
  n_params = sum(p.numel() for p in leaves(state.online_params))
  print(f"{tag} engine built: replay {cfg.num_envs}x{cfg.slots_per_stream} "
        f"rows, {n_params} parameters", flush=True)

  kernels.reset_counts()
  warm = 20  # the learn gate opens at ~2000 active rows (superstep ~18)
  state = engine.run(state, warm)
  torch.cuda.synchronize()
  if state.telemetry.learn_steps == 0:
    fail(f"{name} took no learn step in {warm} supersteps")
  first_loss = float(state.telemetry.last_loss)
  timed = 40
  steps_before = state.telemetry.learn_steps
  counts_before = kernels.counts()
  resets, losses = [], []
  t0 = time.perf_counter()
  for _ in range(timed):
    resets.append(state.env.needs_reset.any())
    state = engine.superstep(state)
    losses.append(state.telemetry.last_loss)
  torch.cuda.synchronize()
  t_run = time.perf_counter() - t0
  counts_after = kernels.counts()
  if state.telemetry.learn_steps - steps_before != timed:
    fail(f"{state.telemetry.learn_steps - steps_before} {name} learn steps "
         f"in {timed} timed supersteps")
  per_learning_superstep = {
      k: (counts_after[k] - counts_before[k]) / timed for k in counts_after
      if k in PATH_KERNELS[name]}
  # act and the target net on K3a (and double_q's selector, the online net
  # on s_t), the online net under grad on K3b.
  want = {"gather_windows": 1, "pooled_frame_to_84": 1,
          "dqn_torso_fwd": 3 if name == "double_q" else 2,
          "dqn_torso_fwd_residuals": 1}
  if per_learning_superstep != want:
    fail(f"launches per {name} learning superstep {per_learning_superstep}, "
         f"expected {want}")
  split = {}
  fenced = 20
  state = engine.run(state, fenced, timings=split)
  torch.cuda.synchronize()
  train_counts = kernels.counts()
  estate = engine.eval_init(seed=12, num_envs=4)
  t0 = time.perf_counter()
  estate = engine.eval_run(state.online_params, estate, 100)
  torch.cuda.synchronize()
  t_eval = time.perf_counter() - t0
  counts = kernels.counts()

  m = engine.metrics(state)
  losses = torch.stack(losses).tolist() + [m.last_loss]
  if m.learn_steps < 20 or not all(math.isfinite(x) for x in losses):
    fail(f"{name}: {m.learn_steps} learn steps, losses {losses}")
  # Near the start: c51's cross-entropy begins at log 51 (near-uniform
  # logits) and stays below it plus a margin; qrdqn's quantile loss within
  # a few times its first value; double_q's squared TD error is positive.
  if name == "c51":
    near = abs(first_loss - math.log(51)) < 0.05 and \
        max(losses) < math.log(51) + 0.5
  elif name == "qrdqn":
    near = 0.0 < first_loss and max(losses) < 4.0 * first_loss + 1.0
  else:
    near = min(losses) >= 0.0 and max(losses) > 0.0
  if not near:
    fail(f"{name} loss left its start: first {first_loss}, then {losses}")
  for k in PATH_KERNELS[name]:
    if counts[k] == 0:
      fail(f"kernel {k} was not launched on the {name} main path")
  if counts["pooled_frame_to_84"] - train_counts["pooled_frame_to_84"] < 100:
    fail(f"{name} eval launched K2 fewer than 100 times")
  if int(estate.env_frames) <= 0:
    fail(f"{name} eval ran no frames")

  # Outputs: the current observations through the kernels, against the
  # plain torso and the same head.
  with torch.no_grad():
    obs = state.stack.frames
    got = engine.network.apply(state.online_params, obs)
    t = state.online_params["torso"]
    plain_torso = torso_cuda.torso_plain(
        t["conv1"]["w"], t["conv1"]["b"], t["conv2"]["w"], t["conv2"]["b"],
        t["conv3"]["w"], t["conv3"]["b"], obs)
    plain_dist = atari.dqn_value_head(state.online_params["head"],
                                      plain_torso)
  if dist_shape is None:  # double_q: the Q-values are the head's output
    dist_shape, dist = (cfg.num_envs, a), got.q_values
  else:
    dist = got.q_logits if name == "c51" else got.q_dist
    plain_dist = plain_dist.reshape(dist_shape)
  if tuple(dist.shape) != dist_shape or \
      tuple(got.q_values.shape) != (cfg.num_envs, a) or \
      not bool(torch.isfinite(dist).all()):
    fail(f"bad {name} outputs {tuple(dist.shape)}")
  torch.testing.assert_close(dist, plain_dist, rtol=1e-4, atol=1e-5)

  # The replay-less checkpoint a chain of legs carries between calls.
  root = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".ckpt",
                      f"chip_smoke_{name}")
  shutil.rmtree(root, ignore_errors=True)
  lite = ckpt.TorchCheckpoint(root)
  save_checkpoint(lite, state, 1, {}, 0, checkpoint_replay=False)
  replayless_bytes = os.path.getsize(lite.state_path())
  shutil.rmtree(root, ignore_errors=True)

  summary = dict(
      supersteps=warm + timed + fenced, learn_steps=m.learn_steps,
      first_loss=first_loss, last_loss=m.last_loss,
      loss_range=[min(losses), max(losses)], replay_size=m.replay_size,
      env_frames=m.env_frames, timed_supersteps=timed,
      training_env_steps_per_s=timed * cfg.num_envs / t_run,
      ms_per_learning_superstep=1e3 * t_run / timed,
      reset_supersteps_in_timed=int(torch.stack(resets).sum()),
      split_ms_per_superstep={k: 1e3 * v / fenced for k, v in split.items()},
      launches_per_learning_superstep=per_learning_superstep,
      parameters=n_params, eval_supersteps=100,
      eval_frames=int(estate.env_frames),
      eval_ms_per_superstep=1e3 * t_eval / 100, train_launches=train_counts,
      eval_launches={k: counts[k] - train_counts[k] for k in counts},
      dist_max_abs_err=float((dist - plain_dist).abs().max()),
      replayless_checkpoint_bytes=replayless_bytes,
      replayless_checkpoint_fits_64mib=replayless_bytes <= 64 * 2**20,
      peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, card=card())
  print(f"{tag} " + json.dumps(summary), flush=True)
  return counts


def phase_iqn_path(dev, game: str = "pong", head_matmul_dtype=None):
  """The port's iqn trainer at full width (latent 64, 64 taus of each
  kind, D = 3136, H = 512, batch 1024) on pong (IQN_MAIN, A = 6) or
  ms_pacman (IQN_MS_PACMAN_MAIN, A = 9, episodes cut short by lost lives)
  through the user's entry points: the acting supersteps below the agent's
  own min fill, on past it through the learn steps, then eval. Prints the
  timed supersteps that took the reset branch and the replay-less
  checkpoint's size against 64 MiB; returns the launch counts. With
  `head_matmul_dtype=torch.bfloat16` (IQN_BF16_HEAD, pong) the network is
  built with the head's bf16-operand mode, as the reference's
  tools/iqn_bf16_tpu.py builds it: K4a, K4b and K4c launch in their bf16
  mode (the `*_bf16` entries, with one staging pass for K4b and K4c) and
  their f32 entries not at all."""
  import shutil
  from dqn_zoo_torch import kernels, nets
  from dqn_zoo_torch.engine.superstep import leaves
  from dqn_zoo_torch.nets import IqnInputs, dqn_torso, iqn_head
  from dqn_zoo_torch.replay.device_replay import replay_size
  from dqn_zoo_torch.run import checkpoint as ckpt
  from dqn_zoo_torch.run.train import build_engine, save_checkpoint

  bf16 = head_matmul_dtype is not None
  tag = "IQN_MAIN" if game == "pong" else f"IQN_{game.upper()}_MAIN"
  overrides = None
  if bf16:
    tag = "IQN_BF16_HEAD"
    overrides = dict(make_network=lambda spec, n: nets.iqn_atari_network(
        n, spec.tau_latent_dim, compute_dtype=spec.compute_dtype,
        head_matmul_dtype=head_matmul_dtype))
  sfx = "_bf16" if bf16 else ""
  fwd, fwd_res, bwd_w, bwd_d = (k + sfx for k in (
      "iqn_head_fwd", "iqn_head_fwd_residuals", "iqn_head_bwd_w",
      "iqn_head_bwd_d"))
  path = "iqn_bf16_head" if bf16 else "iqn"
  engine = build_engine("iqn", game, num_envs=128,
                        replay_capacity=1_000_000, spec_overrides=overrides,
                        device="cuda")
  if engine.network.head_matmul_dtype != head_matmul_dtype:
    fail(f"{tag}: the network's head computes with "
         f"{engine.network.head_matmul_dtype}")
  cfg, spec = engine.config, engine.spec
  a = engine.game.num_actions
  if a != {"pong": 6, "ms_pacman": 9}[game]:
    fail(f"{game} has {a} actions")
  min_fill = spec.min_replay_capacity_fraction * cfg.replay_capacity
  if (spec.tau_samples_policy, spec.tau_samples_s_tm1, spec.tau_samples_s_t,
      spec.tau_latent_dim, spec.optimizer) != (64, 64, 64, 64, "adam") or \
      not 19_000 < min_fill <= 20_000 or \
      (cfg.batch_size, cfg.learn_every, cfg.updates_per_learn) != (1024, 1, 1):
    fail(f"unexpected iqn spec {spec} or schedule {cfg}")
  state = engine.init(seed=3)
  torch.cuda.synchronize()
  print(f"{tag} engine built: replay {cfg.num_envs}x"
        f"{cfg.slots_per_stream} rows, learning starts at {min_fill:.0f} "
        f"rows (superstep ~{min_fill / cfg.num_envs:.0f})", flush=True)

  # 120 supersteps stay below the min fill: acting, replay insert, env step
  # and prep only. 20 warm, 60 timed as they run, 40 with the fenced split.
  kernels.reset_counts()
  warm, timed, fenced = 20, 60, 40
  state = engine.run(state, warm)
  torch.cuda.synchronize()
  size_warm = int(replay_size(state.replay))
  resets = []
  t0 = time.perf_counter()
  for _ in range(timed):
    resets.append(state.env.needs_reset.any())
    state = engine.superstep(state)
  torch.cuda.synchronize()
  t_timed = time.perf_counter() - t0
  split = {}
  state = engine.run(state, fenced, timings=split)
  torch.cuda.synchronize()
  t_last = time.perf_counter() - t0
  acting = warm + timed + fenced
  acting_counts = kernels.counts()
  size_acting = int(replay_size(state.replay))
  if state.telemetry.learn_steps != 0:
    fail(f"iqn took {state.telemetry.learn_steps} learn steps below its min "
         "fill")
  if not size_warm < size_acting < min_fill:
    fail(f"iqn replay did not grow below its min fill: {size_warm} -> "
         f"{size_acting}")
  if acting_counts[fwd] != acting:
    fail(f"{fwd} launches: {acting_counts[fwd]} in {acting} acting "
         "supersteps")

  # On past the min fill: supersteps until the first learn step, 5 more to
  # warm the learn step up, then learning supersteps timed as they run and
  # a fenced split. The online net's leaves are kept to see them move.
  online_before = [p.detach().clone() for p in leaves(state.online_params)]
  bridge = 0
  while state.telemetry.learn_steps == 0:
    if bridge > 60:
      fail("iqn did not start learning within 60 supersteps past the acting "
           "window")
    state = engine.superstep(state)
    bridge += 1
  state = engine.run(state, 5)
  torch.cuda.synchronize()
  learn_timed, learn_fenced = 40, 20
  steps_before = state.telemetry.learn_steps
  counts_before = kernels.counts()
  learn_resets = []
  t0 = time.perf_counter()
  for _ in range(learn_timed):
    learn_resets.append(state.env.needs_reset.any())
    state = engine.superstep(state)
  torch.cuda.synchronize()
  t_learn = time.perf_counter() - t0
  counts_after = kernels.counts()
  per_learning_superstep = {
      k: (counts_after[k] - counts_before[k]) / learn_timed
      for k in counts_after}
  if state.telemetry.learn_steps - steps_before != learn_timed:
    fail(f"{state.telemetry.learn_steps - steps_before} learn steps in "
         f"{learn_timed} timed supersteps")
  want = {fwd_res: 1, bwd_w: 1, bwd_d: 1, "gather_windows": 1,
          "dqn_torso_fwd_residuals": 1, "pooled_frame_to_84": 1,
          fwd: 2, "dqn_torso_fwd": 2}
  if bf16:  # one staging pass feeds both bf16 backward kernels, and each
    # K4a launch stages its weights
    want["iqn_head_stage_bf16"] = 1
    want["iqn_head_stage_fwd_bf16"] = 3
  want = {k: want.get(k, 0) for k in per_learning_superstep}
  if per_learning_superstep != want:
    fail(f"launches per iqn learning superstep {per_learning_superstep}, "
         f"expected {want}")
  learn_split = {}
  state = engine.run(state, learn_fenced, timings=learn_split)
  torch.cuda.synchronize()
  train_counts = kernels.counts()
  supersteps = acting + bridge + 5 + learn_timed + learn_fenced

  estate = engine.eval_init(seed=4, num_envs=4)
  t0 = time.perf_counter()
  estate = engine.eval_run(state.online_params, estate, 100)
  torch.cuda.synchronize()
  t_eval = time.perf_counter() - t0
  counts = kernels.counts()

  m = engine.metrics(state)
  if m.learn_steps < 20:
    fail(f"only {m.learn_steps} iqn learn steps")
  if not math.isfinite(m.last_loss):
    fail(f"iqn loss is not finite: {m.last_loss}")
  if m.replay_size < min_fill:
    fail("iqn replay below its min fill after learning")
  # Act once per superstep and the target net once per learn step.
  if train_counts[fwd] != supersteps + m.learn_steps or \
      counts[fwd] != train_counts[fwd] + 100:
    fail(f"{fwd} launches: {train_counts[fwd]} in {supersteps} training "
         f"supersteps with {m.learn_steps} learn steps, {counts[fwd]} with "
         "the 100 eval supersteps")
  for name in (fwd_res, bwd_w, bwd_d, "gather_windows",
               "dqn_torso_fwd_residuals"):
    if counts[name] != m.learn_steps:
      fail(f"kernel {name} was launched {counts[name]} times in "
           f"{m.learn_steps} iqn learn steps")
  for name in PATH_KERNELS[path]:
    if counts[name] == 0:
      fail(f"kernel {name} was not launched on the {path} path")
  if bf16 and counts["iqn_head_stage_fwd_bf16"] != counts[fwd] + \
      counts[fwd_res]:
    fail(f"{tag}: {counts['iqn_head_stage_fwd_bf16']} staging passes for "
         f"{counts[fwd] + counts[fwd_res]} K4a launches")
  for name in ("pooled_frame_to_84", "dqn_torso_fwd", fwd):
    if counts[name] - train_counts[name] < 100:
      fail(f"kernel {name} was launched {counts[name] - train_counts[name]} "
           "times in the 100 iqn eval supersteps")
  if int(estate.env_frames) <= 0:
    fail("iqn eval ran no frames")
  online_after = leaves(state.online_params)
  moved = [float((a.detach() - b).abs().max())
           for a, b in zip(online_after, online_before)]
  if not all(bool(torch.isfinite(p).all()) for p in online_after) or \
      min(moved) <= 0.0:
    fail(f"iqn online parameters did not all move and stay finite: largest "
         f"change per leaf {moved}")
  if all(torch.equal(t, o.detach()) for t, o in
         zip(leaves(state.target_params), online_after)):
    fail("the iqn target net equals the online net between swaps")

  # Outputs (after the counts were read: this launches K3a and K4a once
  # more): the quantile values of the current observations through the
  # kernels are finite, of shape (128, 64, A), and agree with the plain
  # head on the same torso output; Q is their mean over tau.
  with torch.no_grad():
    obs = state.stack.frames
    taus = torch.rand((cfg.num_envs, spec.tau_samples_policy),
                      generator=state.generator, device=dev)
    out = engine.network.apply(state.online_params, IqnInputs(obs, taus))
    p = state.online_params
    plain = iqn_head.iqn_head_plain(
        p["tau_embed"]["w"], p["tau_embed"]["b"], p["head"]["hidden"]["w"],
        p["head"]["hidden"]["b"], p["head"]["out"]["w"],
        p["head"]["out"]["b"], engine.network.cos_embedding(taus),
        dqn_torso(p["torso"], obs), mm=head_matmul_dtype)
  q_dist = out.q_dist
  if tuple(q_dist.shape) != (128, 64, a) or \
      tuple(out.q_values.shape) != (128, a) or \
      not bool(torch.isfinite(q_dist).all()):
    fail(f"bad iqn quantile values {tuple(q_dist.shape)}")
  if bf16:
    # bf16 operands on both sides, exact products summed in other orders:
    # a few entries round to a neighbouring bf16 value (2^-8 apart), so
    # the whole tensor is held to a relative Frobenius error of 5e-4, as
    # in check_head_bf16.
    if not rel_frobenius(q_dist, plain) <= 5e-4:
      fail(f"{tag} q_dist against the plain bf16 head: "
           f"{rel_frobenius(q_dist, plain)}")
  else:
    torch.testing.assert_close(q_dist, plain, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(out.q_values, plain.mean(dim=1), rtol=1e-4,
                               atol=1e-5)

  # The replay-less checkpoint a chain of legs carries between calls.
  root = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".ckpt",
                      f"chip_smoke_iqn_{game}")
  shutil.rmtree(root, ignore_errors=True)
  lite = ckpt.TorchCheckpoint(root)
  save_checkpoint(lite, state, 1, {}, 0, checkpoint_replay=False)
  replayless_bytes = os.path.getsize(lite.state_path())
  shutil.rmtree(root, ignore_errors=True)

  summary = dict(
      supersteps=supersteps, learn_steps=m.learn_steps,
      last_loss=m.last_loss, replay_size=m.replay_size,
      env_frames=m.env_frames,
      acting_window="no learn step below the min fill",
      acting_supersteps=acting, timed_supersteps=timed,
      ms_per_superstep=1e3 * t_timed / timed,
      acting_only_env_steps_per_s=timed * cfg.num_envs / t_timed,
      ms_per_superstep_last_100=1e3 * t_last / (timed + fenced),
      reset_supersteps_in_timed=int(torch.stack(resets).sum()),
      fenced_supersteps=fenced,
      split_ms_per_superstep={k: 1e3 * v / fenced for k, v in split.items()},
      first_learn_step_at_superstep=acting + bridge,
      learning_timed_supersteps=learn_timed,
      ms_per_learning_superstep=1e3 * t_learn / learn_timed,
      training_env_steps_per_s=learn_timed * cfg.num_envs / t_learn,
      training_env_frames_per_s=4 * learn_timed * cfg.num_envs / t_learn,
      reset_supersteps_in_learning_timed=int(torch.stack(learn_resets).sum()),
      learning_fenced_supersteps=learn_fenced,
      learning_split_ms_per_superstep={
          k: 1e3 * v / learn_fenced for k, v in learn_split.items()},
      launches_per_learning_superstep=per_learning_superstep,
      largest_online_change=max(moved),
      eval_supersteps=100, eval_frames=int(estate.env_frames),
      eval_ms_per_superstep=1e3 * t_eval / 100,
      train_launches=train_counts,
      eval_launches={k: counts[k] - train_counts[k] for k in counts},
      q_dist_max_abs_err=float((q_dist - plain).abs().max()),
      q_dist_rel_frobenius_err=rel_frobenius(q_dist, plain),
      q_dist_shape=list(q_dist.shape),
      replayless_checkpoint_bytes=replayless_bytes,
      replayless_checkpoint_fits_64mib=replayless_bytes <= 64 * 2**20,
      peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, card=card())
  if tag == "IQN_MAIN":
    IQN_READINGS.update(
        ms_per_learning_superstep=summary["ms_per_learning_superstep"],
        training_env_steps_per_s=summary["training_env_steps_per_s"])
  elif bf16:  # beside the f32 head's, read in the same call
    summary.update(f32_head=dict(IQN_READINGS))
  print(f"{tag} " + json.dumps(summary), flush=True)
  return counts


def _same_bits(a, b) -> bool:
  """Tensors equal bit for bit (NaNs included), or numbers equal."""
  if isinstance(a, torch.Tensor):
    return (a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).contiguous().view(torch.uint8),
        b.reshape(-1).contiguous().view(torch.uint8)))
  return type(a) is type(b) and a == b


def _state_spread(got, want) -> dict:
  """{path: max abs difference} over the entries of two engine states that
  differ in any bit (a generator's state or a number: inf)."""
  from dqn_zoo_torch.run.checkpoint import flatten_state
  g, w = flatten_state(got), flatten_state(want)
  if sorted(g) != sorted(w):
    fail("two engine states with different entries")
  out = {}
  for k in w:
    if _same_bits(g[k], w[k]):
      continue
    if isinstance(w[k], torch.Tensor) and w[k].is_floating_point():
      out[k] = float((g[k] - w[k]).abs().max())
    else:
      out[k] = math.inf
  return out


def _host_peak_gb() -> float:
  """Peak resident memory of this process so far (ru_maxrss, KiB)."""
  import resource
  return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9


def phase_resume_path(dev):
  """Checkpoint/resume on the card at dqn/pong's CLI defaults (MAIN's
  lowered min fill): train through a learning window, save with and
  without the replay, restore into a second engine and require every
  entry bit for bit; run `window` supersteps from the live state, from a
  copy of it in memory and from the restored state under cuDNN's
  deterministic algorithms and require all three bit for bit, then the
  live two further under the default ones to print their spread; then two
  legs of the CLI, the first cut by --max_run_seconds partway through its
  train phase, the second resuming there. Returns the launch counts."""
  import shutil
  from dqn_zoo_torch import kernels
  from dqn_zoo_torch.run import checkpoint as ckpt
  from dqn_zoo_torch.run import train

  num_envs, replay_capacity, min_fill = 128, 1_000_000, 0.002
  warm = 60  # the learn gate opens at superstep ~18: ~40 learn steps
  window = 40
  # The CLI legs' train phase, and the first leg's budget: ~1.5 s of eval,
  # then 200-470 of the 800 supersteps at 18-43 ms each.
  leg_supersteps, leg_budget_s = 800, 10
  root = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".ckpt",
                      "chip_smoke")
  shutil.rmtree(root, ignore_errors=True)
  sync = torch.cuda.synchronize

  def make():
    return train.build_engine("dqn", "pong", num_envs=num_envs,
                              replay_capacity=replay_capacity,
                              min_replay_capacity_fraction=min_fill,
                              device=dev)

  kernels.reset_counts()
  engine = make()
  live = engine.run(engine.init(seed=1), warm)
  sync()
  if live.telemetry.learn_steps < 20:
    fail(f"RESUME: only {live.telemetry.learn_steps} learn steps before "
         "the save")

  saved_learn_steps = live.telemetry.learn_steps

  # 1. Save, with the replay and without it.
  host_before = _host_peak_gb()
  full = ckpt.TorchCheckpoint(os.path.join(root, "full"))
  t0 = time.perf_counter()
  full.save(live, iteration=1, writer_state={}, train_done=warm)
  save_s = time.perf_counter() - t0
  host_after_save = _host_peak_gb()
  lite = ckpt.TorchCheckpoint(os.path.join(root, "replayless"))
  t0 = time.perf_counter()
  train.save_checkpoint(lite, live, 1, {}, warm, checkpoint_replay=False)
  lite_save_s = time.perf_counter() - t0

  # 2. Restore into a second engine: first without the replay, then with
  # it, each into the same template. Loaded on the host, copied in place.
  engine_b = make()
  template = engine_b.init(seed=2)
  sync()
  torch.cuda.reset_peak_memory_stats()
  card_before = torch.cuda.memory_allocated()
  t0 = time.perf_counter()
  train.restore_checkpoint(lite, template, checkpoint_replay=False)
  sync()
  lite_restore_s = time.perf_counter() - t0
  t0 = time.perf_counter()
  restored, iteration, _, train_done = full.restore(template)
  sync()
  restore_s = time.perf_counter() - t0
  card_extra = torch.cuda.max_memory_allocated() - card_before
  host_after_restore = _host_peak_gb()
  if (iteration, train_done) != (1, warm):
    fail(f"RESUME: restored iteration {iteration}, train_done {train_done}")
  differ = _state_spread(restored, live)
  if differ:
    fail(f"RESUME: the restored state differs from the saved one: {differ}")
  if restored.replay.value_tree is not restored.replay.indicator_tree:
    fail("RESUME: the uniform replay's tree was split by the restore")

  # 3. The same supersteps from the live state, from a copy of it in
  # memory and from the restored state. The cuDNN weight gradients of the
  # torso backward are not deterministic on the card (two runs from one
  # state part in the last bits and drift apart), so these runs take
  # cuDNN's deterministic algorithms: the two live runs must agree bit for
  # bit, and the restored run must equal them. Then the two live runs go
  # on under the default algorithms, and their spread is printed.
  engine_c = make()
  copy = ckpt.restore_state(engine_c.init(seed=3), ckpt.flatten_state(live))
  deterministic = torch.backends.cudnn.deterministic
  torch.backends.cudnn.deterministic = True
  try:
    live = engine.run(live, window)
    copy = engine_c.run(copy, window)
    sync()
    counts_before = kernels.counts()
    restored = engine_b.run(restored, window)
    sync()
  finally:
    torch.backends.cudnn.deterministic = deterministic
  after_restore = {k: v - counts_before[k]
                   for k, v in kernels.counts().items()}
  spread = _state_spread(copy, live)
  if spread:
    fail(f"RESUME: two runs from one state differ under cuDNN's "
         f"deterministic algorithms: {spread}")
  deviation = _state_spread(restored, live)
  if deviation:
    fail(f"RESUME: two runs from one state agree bit for bit, the restored "
         f"run differs: {deviation}")
  live = engine.run(live, window)
  copy = engine_c.run(copy, window)
  sync()
  default_spread = _state_spread(copy, live)
  for name in PATH_KERNELS["resume"]:
    if after_restore[name] == 0:
      fail(f"RESUME: kernel {name} was not launched after the restore")
  learn_steps = restored.telemetry.learn_steps
  del engine, engine_b, engine_c, live, copy, restored, template
  torch.cuda.empty_cache()

  # 4. Two legs of the CLI: the first cut partway through its train phase
  # by the budget, the second resuming at the saved train_done.
  cli = os.path.join(root, "cli")
  csv_path = os.path.join(root, "cli.csv")
  argv = ["--agent=dqn", "--environment_name=pong", "--device=cuda",
          f"--num_envs={num_envs}", f"--replay_capacity={replay_capacity}",
          f"--min_replay_capacity_fraction={min_fill}", "--num_iterations=1",
          f"--num_train_frames={4 * num_envs * leg_supersteps}",
          f"--num_eval_frames={4 * 4 * 100}", "--eval_num_envs=4",
          f"--checkpoint_path={cli}", f"--results_csv_path={csv_path}",
          "--checkpoint_replay=false", "--save_interval_seconds=4"]
  t0 = time.perf_counter()
  train.main(argv + [f"--max_run_seconds={leg_budget_s}"])
  leg1_s = time.perf_counter() - t0
  meta = ckpt.TorchCheckpoint(cli).meta()
  if meta["iteration"] != 1 or not 0 < meta["train_done"] < leg_supersteps:
    fail(f"RESUME: the first CLI leg did not stop partway through train: "
         f"{meta}")
  t0 = time.perf_counter()
  final = train.main(argv)
  leg2_s = time.perf_counter() - t0
  with open(csv_path) as f:
    rows = [int(line.split(",")[0]) for line in f.readlines()[1:]]
  if rows != [0, 1]:
    fail(f"RESUME: the CSV holds iterations {rows}, not [0, 1]")
  if final.superstep != leg_supersteps:
    fail(f"RESUME: the legs ran {final.superstep} supersteps, not "
         f"{leg_supersteps}")
  counts = kernels.counts()
  summary = dict(
      supersteps_before_save=warm, learn_steps_before_save=saved_learn_steps,
      window_supersteps=window, learn_steps_after_window=learn_steps,
      save_s=save_s, restore_s=restore_s,
      replayless_save_s=lite_save_s, replayless_restore_s=lite_restore_s,
      checkpoint_bytes=os.path.getsize(full.state_path()),
      replayless_checkpoint_bytes=os.path.getsize(lite.state_path()),
      restore_card_peak_extra_gb=card_extra / 1e9,
      host_peak_gb_before_save=host_before,
      host_peak_gb_after_save=host_after_save,
      host_peak_gb_after_restore=host_after_restore,
      card_peak_gb=torch.cuda.max_memory_allocated() / 1e9,
      restored_exact=True, restored_run_bit_identical=True,
      default_cudnn_run_to_run_spread=default_spread,
      launches_after_restore=after_restore,
      cli_leg1_train_done=meta["train_done"], cli_leg1_s=leg1_s,
      cli_leg2_s=leg2_s, cli_csv_iterations=rows)
  print("RESUME " + json.dumps(summary), flush=True)
  shutil.rmtree(root, ignore_errors=True)
  return counts


def phase_host_agent_path(dev, fill: int = 2200, timed: int = 2400,
                          fenced: int = 1400):
  """HOST_AGENT: the reference's single-stream agent surface at full width.

  HostAgent(get_agent("dqn"), 6, ...) — the Nature DQN, batch 32, learn
  period 16, target period 40,000 frames, centred RMSProp — over
  GameEnvironment("pong") on the card and processors.atari(), driven by
  parts.run_loop with make_default_trackers. Replay capacity 1e6 with
  compressed observations, as the reference runs Atari (the ring holds
  only what was added); min fill 0.0005 of it (500 transitions, ~2,000
  frames), so that learning starts in the run. `fill` frames, then
  `timed` frames unfenced (frames/s), then `fenced` frames with each of
  env step, processor, act, replay add, replay sample and learn fenced by
  a synchronize (PhaseTimer); then TRACE of 20 frames that hold a learn
  step. Checks: a finite loss and >= 200 learn steps; the Q-values of the
  act on one observation against the plain torso; K3a once a learn step
  (target) and once an act (B = 1), K3b once a learn step; K1 and K2 never
  (the host replay stacks transitions in NumPy, the processor resizes on
  the host). Returns the launch counts."""
  import itertools

  import numpy as np
  from dqn_zoo_torch import kernels, parts, processors
  from dqn_zoo_torch.agents import get_agent
  from dqn_zoo_torch.envs.dm_adapter import GameEnvironment
  from dqn_zoo_torch.host_agent import HostAgent
  from dqn_zoo_torch.utils.profiling import PhaseTimer

  spec = dataclasses.replace(get_agent("dqn"),
                             min_replay_capacity_fraction=0.0005)
  if (spec.batch_size, spec.learn_period,
      spec.target_network_update_period) != (32, 16, 40_000):
    fail(f"unexpected dqn schedule {spec}")
  env = GameEnvironment("pong", seed=1, device=dev)
  preprocessor = processors.atari()
  agent = HostAgent(spec, env.action_spec().num_values,
                    np.zeros((84, 84, 4), np.uint8), seed=1,
                    preprocessor=preprocessor, replay_capacity=1_000_000,
                    compress_state=True, device=dev)

  # Counters and, for the fenced window, timers around the agent's parts.
  timer = PhaseTimer()
  calls = {"act": 0, "learn": 0}
  fence = {"on": False}
  params = agent.online_params

  def wrap(name, fn, block_on=None, count=None):
    def run(*args, **kwargs):
      if count:
        calls[count] += 1
      if not fence["on"]:
        return fn(*args, **kwargs)
      with timer(name, block_on=block_on):
        return fn(*args, **kwargs)
    return run

  last = {}

  def process(timestep):
    out = preprocessor(timestep)
    if out is not None:
      last["observation"] = out.observation
    return out

  env.step = wrap("env_step", env.step, block_on=params)
  env.reset = wrap("env_reset", env.reset, block_on=params)
  agent._preprocessor = wrap("processor", process)
  agent._act = wrap("act", agent._act, block_on=params, count="act")
  agent._learn = wrap("learn", agent._learn, block_on=params, count="learn")
  agent._replay.add = wrap("replay_add", agent._replay.add)
  agent._replay.sample = wrap("replay_sample", agent._replay.sample)

  loop = parts.run_loop(agent, env)
  trackers = parts.make_default_trackers(agent)
  torch.cuda.synchronize()
  kernels.reset_counts()
  t0 = time.perf_counter()
  parts.generate_statistics(trackers, itertools.islice(loop, fill))
  torch.cuda.synchronize()
  fill_s = time.perf_counter() - t0
  learn_before, act_before = calls["learn"], calls["act"]
  counts_before = kernels.counts()
  t0 = time.perf_counter()
  stats = parts.generate_statistics(trackers, itertools.islice(loop, timed))
  torch.cuda.synchronize()
  timed_s = time.perf_counter() - t0
  timed_learns = calls["learn"] - learn_before
  timed_acts = calls["act"] - act_before
  timed_counts = {k: v - counts_before[k] for k, v in kernels.counts().items()}
  fence["on"] = True
  parts.generate_statistics(trackers, itertools.islice(loop, fenced))
  fence["on"] = False
  torch.cuda.synchronize()
  counts = kernels.counts()
  learns, acts = calls["learn"], calls["act"]

  loss = agent._statistics.get("loss", float("nan"))
  if learns < 200 or not math.isfinite(loss):
    fail(f"HOST_AGENT: {learns} learn steps, last loss {loss}")
  if timed_learns == 0:
    fail("HOST_AGENT: no learn step in the timed window")
  want = {"gather_windows": 0, "pooled_frame_to_84": 0,
          "dqn_torso_fwd": acts + learns, "dqn_torso_fwd_residuals": learns}
  got = {k: counts.get(k, 0) for k in want}
  if got != want:
    fail(f"HOST_AGENT launches {got}, expected {want} ({acts} acts, "
         f"{learns} learn steps)")
  for name in PATH_KERNELS["host_agent"]:
    if counts[name] == 0:
      fail(f"kernel {name} was not launched on the host agent path")
  obs = torch.from_numpy(last["observation"][None]).to(dev)
  q_err = _dqn_q_against_plain(agent.network, agent.online_params, obs)

  # TRACE: 20 frames that hold a learn step (every 16th frame learns).
  def frames():
    for _ in itertools.islice(loop, 20):
      pass
  learn_before = calls["learn"]
  traced_window("HOST_AGENT", frames, PATH_KERNELS["host_agent"])
  if calls["learn"] == learn_before:
    fail("HOST_AGENT: the traced frames held no learn step")

  split = timer.summary()
  print("HOST_AGENT " + json.dumps(dict(
      frames=fill + timed + fenced, fill_frames=fill,
      fill_frames_per_s=fill / fill_s, timed_frames=timed,
      timed_frames_per_s=timed / timed_s,
      timed_learn_steps=timed_learns, timed_acts=timed_acts,
      timed_ms_per_frame=1e3 * timed_s / timed,
      timed_launches=timed_counts, fenced_frames=fenced,
      fenced_split=split, learn_steps=learns, acts=acts, last_loss=loss,
      replay_size=agent._replay.size,
      episode_return=stats["episode_return"],
      num_episodes=stats["num_episodes"],
      state_value=stats["state_value"], train_launches=counts,
      q_max_abs_err=q_err,
      peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, card=card())),
      flush=True)
  return counts


def _free_port() -> int:
  import socket
  with socket.socket() as sock:
    sock.bind(("localhost", 0))
    return sock.getsockname()[1]


def _dqn_launches_per_learning_superstep(tag, before, after, supersteps):
  per = {k: (after[k] - before[k]) / supersteps for k in after}
  for name, n in DQN_PER_LEARNING_SUPERSTEP.items():
    if per[name] != n:
      fail(f"{tag}: {name} launched {per[name]} times a learning "
           f"superstep, not {n}")
  return per


def phase_dist_main(dev):
  """DIST_MAIN: dqn/pong through train_dist.build_trainer and
  DistributedTrainer at world size 1 over NCCL (the production backend),
  at MAIN's config; the gradient all-reduce alone; then 40 supersteps of
  the trainer and of a plain Engine from one state and one set of draws
  under cuDNN's deterministic algorithms, bit for bit (a SUM over one rank
  divided by 1 is exact). Returns the launch counts of the drive."""
  import torch.distributed as dist
  from dqn_zoo_torch import kernels
  from dqn_zoo_torch.engine import Engine
  from dqn_zoo_torch.run import checkpoint as ckpt
  from dqn_zoo_torch.run import train_dist
  from dqn_zoo_torch.utils.pytree import leaves

  dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                          f"{_free_port()}", rank=0, world_size=1)
  try:
    trainer = train_dist.build_trainer(
        "dqn", "pong", 1, 128, 1_000_000, min_replay_capacity_fraction=0.002,
        device=dev)
    cfg = trainer.engine.config
    if (cfg.num_envs, cfg.batch_size, cfg.learn_every, cfg.updates_per_learn,
        cfg.frame_multiplier) != (128, 1024, 1, 1, 1):
      fail(f"DIST_MAIN: unexpected config {cfg}")
    state = trainer.init(seed=1)
    torch.cuda.synchronize()
    kernels.reset_counts()
    warm, timed, fenced = 20, 100, 20
    t0 = time.perf_counter()
    state = trainer.run(state, warm)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    steps_before, counts_before = (state.telemetry.learn_steps,
                                   kernels.counts())
    t0 = time.perf_counter()
    state = trainer.run(state, timed)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    if state.telemetry.learn_steps - steps_before != timed:
      fail(f"DIST_MAIN: {state.telemetry.learn_steps - steps_before} learn "
           f"steps in {timed} timed supersteps")
    per = _dqn_launches_per_learning_superstep(
        "DIST_MAIN", counts_before, kernels.counts(), timed)
    split = {}
    state = trainer.run(state, fenced, timings=split)
    torch.cuda.synchronize()
    counts = kernels.counts()

    m = trainer.metrics(state)
    own = trainer.engine.metrics(state)
    if m["learn_steps"] < 20 or m["learn_steps"] != own.learn_steps:
      fail(f"DIST_MAIN: learn steps {m['learn_steps']} ({own.learn_steps})")
    if not math.isfinite(own.last_loss):
      fail(f"DIST_MAIN: loss is not finite: {own.last_loss}")
    if m["env_frames"] != own.env_frames:
      fail(f"DIST_MAIN: metrics over one rank {m} against {own}")
    q_err = _dqn_q_against_plain(trainer.engine.network, state.online_params,
                                 state.stack.frames)

    # The gradient all-reduce alone, at the net's size.
    numel = sum(p.numel() for p in leaves(state.online_params))
    buf = torch.randn(numel, device=dev)
    allreduce_ms = time_ms(lambda: dist.all_reduce(buf), iters=50, warmup=5)

    # The trainer against a plain Engine from one state (and so one
    # generator: the same draws).
    engine = Engine(dataclasses.replace(cfg, pmap_axis=None), device=dev)
    copy = ckpt.restore_state(engine.init(seed=2), ckpt.flatten_state(state))
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
      state = trainer.run(state, 40)
      copy = engine.run(copy, 40)
      torch.cuda.synchronize()
    finally:
      torch.backends.cudnn.deterministic = deterministic
    spread = _state_spread(state, copy)
    if spread:
      fail(f"DIST_MAIN: the trainer and the Engine differ after 40 "
           f"supersteps from one state: {spread}")
    summary = dict(
        world_size=1, backend="nccl", supersteps=warm + timed + fenced,
        learn_steps=m["learn_steps"], last_loss=own.last_loss,
        warm_s=t_warm, timed_supersteps=timed,
        ms_per_superstep=1e3 * t_run / timed,
        env_steps_per_s=timed * cfg.num_envs / t_run,
        split_ms_per_superstep={k: 1e3 * v / fenced
                                for k, v in split.items()},
        launches_per_learning_superstep=per, train_launches=counts,
        allreduce_floats=numel, allreduce_mb=4 * numel / 1e6,
        allreduce_ms=allreduce_ms, metrics=m, q_max_abs_err=q_err,
        engine_equal_bit_for_bit_supersteps=40,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, card=card())
    print("DIST_MAIN " + json.dumps(summary), flush=True)
    return counts
  finally:
    dist.destroy_process_group()


def dist_worker(rank: int, port: int) -> int:
  """One rank of DIST_TWO_RANKS (`chip_smoke.py --dist-worker RANK PORT`):
  dqn/pong through train_dist.build_trainer over gloo on the one card, at
  global 128 streams, replay 1e6 and batch 1024 split over two ranks;
  prints `DIST_RANK {...}` with its readings and launch counts."""
  import torch.distributed as dist
  here = os.path.dirname(os.path.abspath(__file__))
  sys.path.insert(0, here)
  from dqn_zoo_torch import kernels
  from dqn_zoo_torch.device import resolve_device
  from dqn_zoo_torch.replay import device_replay as dr
  from dqn_zoo_torch.run import train_dist
  from dqn_zoo_torch.utils.pytree import leaves

  dev = resolve_device("cuda")
  dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                          rank=rank, world_size=2)
  try:
    trainer = train_dist.build_trainer(
        "dqn", "pong", 2, 128, 1_000_000, min_replay_capacity_fraction=0.002,
        device=dev)
    cfg = trainer.engine.config
    if (cfg.num_envs, cfg.batch_size, cfg.frame_multiplier) != (64, 512, 2):
      fail(f"DIST_TWO_RANKS: unexpected config {cfg}")
    state = trainer.init(seed=1)
    torch.cuda.synchronize()
    kernels.reset_counts()
    warm, timed = 20, 40
    state = trainer.run(state, warm)
    torch.cuda.synchronize()
    steps_before, counts_before = (state.telemetry.learn_steps,
                                   kernels.counts())
    t0 = time.perf_counter()
    state = trainer.run(state, timed)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    counts = kernels.counts()
    learned = state.telemetry.learn_steps - steps_before
    if learned != timed:
      fail(f"DIST_TWO_RANKS rank {rank}: {learned} learn steps in {timed} "
           "timed supersteps")
    per = _dqn_launches_per_learning_superstep(
        f"DIST_TWO_RANKS rank {rank}", counts_before, counts, timed)

    def gathered(t):
      out = [torch.empty_like(t) for _ in range(2)]
      dist.all_gather(out, t)
      return out

    online = torch.cat([p.detach().reshape(-1)
                        for p in leaves(state.online_params)]).cpu()
    same_params = all(torch.equal(o, online) for o in gathered(online))
    rows = state.replay.t
    frames = state.replay.frames[0, :rows].reshape(-1).cpu()
    frames_differ = not torch.equal(*gathered(frames))
    own = trainer.engine.metrics(state)
    mine = torch.tensor([own.env_frames, own.episodes, own.learn_steps,
                         int(dr.replay_size(state.replay))],
                        dtype=torch.float64)
    ranks = gathered(mine)
    m = trainer.metrics(state)
    total = (ranks[0] + ranks[1]).tolist()
    sums_equal = [m["env_frames"], m["episodes"], m["learn_steps"]] == \
        total[:3]
    numel = online.numel()
    buf = torch.randn(numel, device=dev)
    for _ in range(3):
      dist.all_reduce(buf)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
      dist.all_reduce(buf)
    torch.cuda.synchronize()
    allreduce_ms = 1e3 * (time.perf_counter() - t0) / 20
    print("DIST_RANK " + json.dumps(dict(
        rank=rank, learn_steps=state.telemetry.learn_steps,
        last_loss=own.last_loss, ms_per_superstep=1e3 * t_run / timed,
        env_steps_per_s=timed * cfg.num_envs / t_run,
        launches=counts, launches_per_learning_superstep=per,
        params_equal_across_ranks=same_params,
        replay_frames_differ=frames_differ, metrics=m,
        rank_metrics=[r.tolist() for r in ranks],
        metric_sums_equal=sums_equal, allreduce_floats=numel,
        allreduce_ms=allreduce_ms,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)), flush=True)
    if not (same_params and frames_differ and sums_equal):
      fail(f"DIST_TWO_RANKS rank {rank}: params equal {same_params}, "
           f"frames differ {frames_differ}, metric sums {m} against "
           f"{total}")
    if own.learn_steps < 20 or not math.isfinite(own.last_loss):
      fail(f"DIST_TWO_RANKS rank {rank}: {own}")
  finally:
    dist.destroy_process_group()
  return 0


def phase_dist_two_ranks(dev, timeout_s: float = 480.0):
  """DIST_TWO_RANKS: two worker processes of this script on the one card,
  over gloo (NCCL takes one card a rank). A worker that fails, or that is
  still running at `timeout_s`, fails the phase; both are stopped either
  way. Returns the two ranks' launch counts summed."""
  import tempfile
  del dev
  port = _free_port()
  t0 = time.perf_counter()
  with tempfile.TemporaryDirectory() as tmp:
    logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+") for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--dist-worker", str(r),
         str(port)], stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(2)]
    try:
      while time.perf_counter() - t0 < timeout_s:
        codes = [p.poll() for p in procs]
        if all(c is not None for c in codes) or any(c for c in codes):
          break
        time.sleep(0.5)
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
  wall_s = time.perf_counter() - t0
  readings = []
  for r, (p, out) in enumerate(zip(procs, outs)):
    lines = [ln for ln in out.splitlines() if ln.startswith("DIST_RANK ")]
    if p.returncode != 0 or not lines:
      fail(f"DIST_TWO_RANKS: rank {r} exited {p.returncode}:\n"
           f"{out[-3000:]}")
    readings.append(json.loads(lines[-1][len("DIST_RANK "):]))
  counts = {k: readings[0]["launches"][k] + readings[1]["launches"][k]
            for k in readings[0]["launches"]}
  print("DIST_TWO_RANKS " + json.dumps(dict(
      world_size=2, backend="gloo", wall_s=wall_s, ranks=readings,
      card=card())), flush=True)
  return counts


def phase_dist_cli(dev):
  """DIST_CLI: `torchrun --nproc_per_node=1 -m dqn_zoo_torch.run.train
  --mesh_devices=1` on dqn/pong at the CLI's widths for one train
  iteration (40 supersteps) and two eval phases, with a replay-less rank
  checkpoint; its CSV must hold iterations 0 and 1 in the 14 columns."""
  import csv
  import shutil
  del dev
  here = os.path.dirname(os.path.abspath(__file__))
  root = os.path.join(here, ".ckpt", "chip_smoke_dist")
  shutil.rmtree(root, ignore_errors=True)
  csv_path = os.path.join(root, "cli.csv")
  cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes=1",
         "--nproc_per_node=1", "--master_addr=localhost",
         f"--master_port={_free_port()}", "-m", "dqn_zoo_torch.run.train",
         "--mesh_devices=1", "--agent=dqn", "--environment_name=pong",
         "--num_iterations=1", f"--num_train_frames={4 * 128 * 40}",
         "--num_eval_frames=1600", "--eval_num_envs=4",
         "--min_replay_capacity_fraction=0.002",
         f"--results_csv_path={csv_path}",
         f"--checkpoint_path={os.path.join(root, 'ckpt')}",
         "--checkpoint_replay=false"]
  t0 = time.perf_counter()
  try:
    proc = subprocess.run(cmd, cwd=here, capture_output=True, text=True,
                          timeout=420)
  except subprocess.TimeoutExpired:
    fail("DIST_CLI: torchrun did not finish in 420 s")
  wall_s = time.perf_counter() - t0
  if proc.returncode != 0:
    fail(f"DIST_CLI: exit {proc.returncode}:\n{proc.stdout[-2000:]}\n"
         f"{proc.stderr[-3000:]}")
  with open(csv_path) as f:
    rows = list(csv.DictReader(f))
  with open(os.path.join(root, "ckpt", "meta.json")) as f:
    meta = json.load(f)
  if [int(r["iteration"]) for r in rows] != [0, 1] or \
      any(len(r) != 14 for r in rows):
    fail(f"DIST_CLI: the CSV holds {rows}")
  if (meta["world_size"], meta["iteration"]) != (1, 2):
    fail(f"DIST_CLI: checkpoint meta {meta}")
  print("DIST_CLI " + json.dumps(dict(
      wall_s=wall_s, columns=list(rows[0]), rows=rows,
      checkpoint_files=sorted(os.listdir(os.path.join(root, "ckpt"))))),
      flush=True)
  shutil.rmtree(root, ignore_errors=True)


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
  # K4a's bf16 kernel's, K4b's and K4c's (both modes) and K2's blocks take
  # dynamic shared memory, which ptxas does not count: their sources report
  # it.
  from dqn_zoo_torch.prep import cuda_prep
  smem = kernels.load("iqn_head_bwd.cu").dz_iqn_head_bwd_smem
  smem_bf16 = kernels.load("iqn_head_bwd_bf16.cu").dz_iqn_head_bwd_bf16_smem
  fwd_bf16 = kernels.load("iqn_head_bf16.cu").dz_iqn_head_fwd_bf16_sizes
  plan = cuda_prep.band_plan()
  dynamic = {"iqn_head_bwd_w_kernel": smem(0),
             "iqn_head_bwd_d_kernel": smem(1),
             "bwd_w_bf16_kernel": smem_bf16(0),
             "bwd_d_bf16_kernel": smem_bf16(1),
             "fwd_bf16_kernel": fwd_bf16(2),
             "pooled_frame_to_84_kernel": kernels.load(
                 "pooled_frame_to_84.cu").dz_pooled_frame_to_84_smem(
                     plan.max_rows)}
  for source, log in sorted(kernels.BUILD_LOG.items()):
    report = ptxas_report(log)
    for entry in report:
      for name, nbytes in dynamic.items():
        # The kernel's own name in the mangled one (after its length), not
        # a longer name that ends with it.
        if re.search(rf"\d{name}[IE]", entry["function"]):
          entry["dynamic_smem_bytes"] = nbytes
    print(f"PTXAS {source} {json.dumps(report)}", flush=True)

  checks = phase_kernels(dev)
  check_seaquest(dev)
  check_games(dev)
  check_pil(dev)
  # Each engine holds a 7 GB frame store: one path's state is dropped
  # before the next is built.
  path_counts = {}
  for path, phase in (("dqn", phase_main_path),
                      ("bf16", phase_bf16_path),
                      ("prioritized", phase_per_path),
                      ("rainbow", phase_rainbow_path),
                      ("rainbow_breakout", lambda d: phase_rainbow_path(
                          d, "breakout", timed=40, fenced=20,
                          eval_supersteps=100)),
                      ("rainbow_zaxxon", lambda d: phase_rainbow_path(
                          d, "zaxxon", timed=40, fenced=20,
                          eval_supersteps=100)),
                      ("pil", phase_pil_path),
                      ("host", phase_host_path),
                      ("overlap", phase_overlap_path),
                      ("c51", lambda d: phase_learner_path(d, "c51")),
                      ("qrdqn", lambda d: phase_learner_path(d, "qrdqn")),
                      ("double_q", lambda d: phase_learner_path(
                          d, "double_q", "demon_attack")),
                      ("iqn", phase_iqn_path),
                      ("iqn_bf16_head", lambda d: phase_iqn_path(
                          d, head_matmul_dtype=torch.bfloat16)),
                      ("iqn_ms_pacman", lambda d: phase_iqn_path(
                          d, "ms_pacman")),
                      ("resume", phase_resume_path),
                      ("host_agent", phase_host_agent_path),
                      ("dist", phase_dist_main),
                      ("dist_two_ranks", phase_dist_two_ranks)):
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    path_counts[path] = phase(dev)
  torch.cuda.empty_cache()
  phase_dist_cli(dev)

  entries = []
  for name in TPU_KERNELS:
    by_path = {path: path_counts[path][name]
               for path, names in PATH_KERNELS.items() if name in names}
    entry = dict(
        name=name, route="cuda", source=SOURCES[name],
        replaces=TPU_KERNELS[name], launches=sum(by_path.values()),
        max_abs_err=checks[name]["max_abs_err"], ms=checks[name]["ms"],
        plain_ms=checks[name]["plain_ms"], bound_ms=checks[name]["bound_ms"],
        bound_by=checks[name]["bound_by"],
        library_ms=checks[name]["library_ms"], shape=checks[name]["shape"],
        launches_by_path=by_path)
    if "bound_3xtf32_ms" in checks[name]:
      entry["bound_3xtf32_ms"] = checks[name]["bound_3xtf32_ms"]
    if not entry["launches"]:
      fail(f"kernel {name} was launched on no main path")
    entries.append(entry)
  print(json.dumps({"kernels": entries}))
  print(card())
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}))
  return 0


if __name__ == "__main__":
  if sys.argv[1:2] == ["--dist-worker"]:
    sys.exit(dist_worker(int(sys.argv[2]), int(sys.argv[3])))
  sys.exit(main())
