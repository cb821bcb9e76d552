"""Device intervals from torch.profiler, and what the readers take from them.

The profiler records device activity only (CUPTI: kernels, copies and
memsets), so the host runs at its own pace and not at the profiler's. An
event is (name, start µs, end µs) on the device's clock.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import torch

Event = Tuple[str, float, float]


class DeviceTrace:
  """`with DeviceTrace(device) as t:` profiles the block; `t.events()`
  afterwards gives its device events (none on a CPU device)."""

  def __init__(self, device):
    self.device = torch.device(device)
    self._prof = None

  def __enter__(self) -> "DeviceTrace":
    acts = [torch.profiler.ProfilerActivity.CUDA] \
        if self.device.type == "cuda" else [
            torch.profiler.ProfilerActivity.CPU]
    self._prof = torch.profiler.profile(activities=acts)
    self._prof.start()
    return self

  def __exit__(self, *exc) -> None:
    self._prof.stop()

  def events(self) -> List[Event]:
    if self.device.type != "cuda":
      return []
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in self._prof.profiler.kineto_results.events():
      if e.device_type() == cuda and e.duration_ns() > 0:
        start = e.start_ns() / 1e3
        out.append((e.name(), start, start + e.duration_ns() / 1e3))
    return out


def union(events: Iterable[Event]) -> List[Tuple[float, float, str]]:
  """The union of the intervals as (start, end, name of its first event),
  in time order."""
  segs: List[List] = []
  for name, a, b in sorted(events, key=lambda e: e[1]):
    if segs and a <= segs[-1][1]:
      segs[-1][1] = max(segs[-1][1], b)
    else:
      segs.append([a, b, name])
  return [tuple(s) for s in segs]


def busy_seconds(events: List[Event]) -> float:
  return sum(b - a for a, b, _ in union(events)) / 1e6


def kernel_seconds(events: List[Event], names: Iterable[str]) -> float:
  """Device seconds of the events whose name holds one of `names`."""
  names = tuple(names)
  return sum(b - a for n, a, b in events if any(k in n for k in names)) / 1e6


def breakdown(events: List[Event], top: int = 10) -> Dict[str, list]:
  """The device operations that took most time, and the longest idle gaps,
  each named by the operation that ended it ("before <op>")."""
  by: Dict[str, float] = {}
  for n, a, b in events:
    by[n] = by.get(n, 0.0) + (b - a) / 1e6
  ops = sorted(by.items(), key=lambda kv: -kv[1])[:top]
  segs = union(events)
  gaps = [(f"before {nxt[2]}", (nxt[0] - cur[1]) / 1e6)
          for cur, nxt in zip(segs, segs[1:])]
  gaps = sorted(gaps, key=lambda g: -g[1])[:top]
  return {"device_ops": [[n[:200], s] for n, s in ops],
          "idle_gaps": [[n[:200], s] for n, s in gaps]}
