"""Profiling helpers (port of dqn_zoo_tpu/utils/profiling.py).

`trace()` records the enclosed block with `torch.profiler` (CPU activity,
and CUDA activity where a card is present) and writes a Chrome trace into
`logdir`, viewable in Perfetto or chrome://tracing. `PhaseTimer` aggregates
wall-clock time per named phase, fenced by a device synchronize where asked.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Iterator

import torch


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
  """Profiles the enclosed block; yields the profiler (for `key_averages()`
  after the block) and on exit writes `trace_<pid>_<ns>.json` into
  `logdir`, whose path is then the profiler's `trace_path`."""
  activities = [torch.profiler.ProfilerActivity.CPU]
  if torch.cuda.is_available():
    activities.append(torch.profiler.ProfilerActivity.CUDA)
  prof = torch.profiler.profile(activities=activities)
  prof.start()
  try:
    yield prof
  finally:
    prof.stop()
    os.makedirs(logdir, exist_ok=True)
    prof.trace_path = os.path.join(
        logdir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(prof.trace_path)


def _cuda_devices(tree, found: set) -> set:
  if isinstance(tree, torch.Tensor):
    if tree.is_cuda:
      found.add(tree.device)
  elif isinstance(tree, dict):
    for v in tree.values():
      _cuda_devices(v, found)
  elif isinstance(tree, (list, tuple)):
    for v in tree:
      _cuda_devices(v, found)
  return found


class PhaseTimer:
  """Accumulates wall-clock per named phase; `block_on` (a tensor or a
  nest of them) fences the phase with a synchronize of each CUDA device it
  holds a tensor on, and does nothing for CPU tensors."""

  def __init__(self):
    self.totals = defaultdict(float)
    self.counts = defaultdict(int)

  @contextlib.contextmanager
  def __call__(self, name: str, block_on=None) -> Iterator[None]:
    t0 = time.perf_counter()
    try:
      yield
    finally:
      if block_on is not None:
        for dev in _cuda_devices(block_on, set()):
          torch.cuda.synchronize(dev)
      self.totals[name] += time.perf_counter() - t0
      self.counts[name] += 1

  def summary(self) -> dict:
    return {k: {"total_s": self.totals[k], "count": self.counts[k],
                "mean_ms": 1e3 * self.totals[k] / max(1, self.counts[k])}
            for k in self.totals}
