"""Profiling: the program's spans and counters, fenced stage laps, and
torch.profiler traces (port of dqn_zoo_tpu/utils/profiling.py, whose
`trace` and `PhaseTimer` these are; the recorder is the port's own).

The recorder. `span(name)` marks a piece of host work: its name, start and
end on one host clock (`time.perf_counter_ns`), the span open around it
(its parent) and the superstep it belongs to. `span` begins the span when
called and returns a context manager that ends it, so it serves as a
`with` block or, on hot lines, as a plain `span(name)` ... `end()` pair.
`root(name, step)` opens a superstep's span: its children carry `step` as
their superstep id. `count(name, n)` adds to a named counter, and
`host_read(tensor, name)` is the one way the program reads the device:
it opens the span `sync.<name>` and counts it under `host_syncs`.

The recorder is off unless `recording()` (or `trace()`) holds it on, or
torch.profiler records: each root turns it on while a profiler records and
off once none does, so any profile of the program carries its spans, as
`torch.profiler.record_function` ranges are recorded only under a
profiler. Off, `span` returns one shared no-op object and `count` returns
at once: one flag test each. Spans are kept in memory, the newest
`capacity` of them (older ones are dropped and counted), until `drain()`
hands them out; the recorder writes no file.

One clock with the device trace: each time the recorder turns on or off it
keeps an anchor, a pair of readings of its own clock and of
`time.time_ns`, the Unix clock that torch.profiler's events
(`kineto_results.events()`, `start_ns()`) read. `profiler_ns` maps a span's
time onto the profiler's clock by the anchors.

`fence(device, timings)` gives an engine's fenced stage laps (the
engines' `timings=`): each `lap(name)` synchronizes the device and adds
the seconds since the previous lap to `timings[name]`; without `timings`,
a shared object whose laps do nothing.

`trace()` records the enclosed block with `torch.profiler` (CPU activity,
and CUDA activity where a card is present) with the recorder on, and writes
a Chrome trace into `logdir` (Perfetto, chrome://tracing) that holds the
block's spans as one more host track. `PhaseTimer` aggregates wall-clock
time per named phase, fenced by a device synchronize where asked.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import itertools
import json
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

CAPACITY = 1 << 16
_clock = time.perf_counter_ns


class Span(NamedTuple):
  name: str
  start_ns: int  # the recorder's clock (time.perf_counter_ns)
  end_ns: int
  id: int
  parent: int  # the enclosing span's id; -1 for none
  step: int  # the superstep's id: the root's `step`, else the root's id


class Anchor(NamedTuple):
  host_ns: int  # the recorder's clock
  profiler_ns: int  # time.time_ns: the clock of torch.profiler's events


class Drained(NamedTuple):
  spans: List[Span]  # in the order they opened
  counters: Dict[str, int]
  dropped: int  # spans pushed out of the full buffer since the last drain
  anchors: List[Anchor]


class _NoOp:
  """What `span` returns while the recorder is off."""

  def __enter__(self):
    return self

  def __exit__(self, *exc):
    return False


class _Closer:
  """What `span` returns while the recorder is on: ends the span."""

  def __init__(self, recorder: "Recorder"):
    self._recorder = recorder

  def __enter__(self):
    return self

  def __exit__(self, *exc):
    self._recorder.end()
    return False


NOOP = _NoOp()


def anchor(tries: int = 5) -> Anchor:
  """A reading of both clocks: the Unix clock between two readings of the
  host's, the tightest pair of `tries` (a thread switched out between two
  readings would put the anchor off by its pause)."""
  best = None
  for _ in range(tries):
    a = _clock()
    unix = time.time_ns()
    b = _clock()
    if best is None or b - a < best[0]:
      best = (b - a, Anchor((a + b) // 2, unix))
  return best[1]


def profiler_ns(host_ns: int, anchors: List[Anchor]) -> float:
  """`host_ns` (the recorder's clock) on torch.profiler's clock: the
  offset between the clocks interpolated between the anchors around it,
  the nearest anchor's outside them."""
  if not anchors:
    raise ValueError("no anchor to map the recorder's clock by")
  i = bisect.bisect_right([a.host_ns for a in anchors], host_ns)
  off = lambda a: a.profiler_ns - a.host_ns
  if i == 0 or i == len(anchors):
    return host_ns + off(anchors[min(i, len(anchors) - 1)])
  lo, hi = anchors[i - 1], anchors[i]
  w = (host_ns - lo.host_ns) / max(1, hi.host_ns - lo.host_ns)
  return host_ns + off(lo) + w * (off(hi) - off(lo))


class Recorder:
  """Spans and counters in memory; see the module's docstring."""

  def __init__(self, capacity: int = CAPACITY):
    self.on = False
    self._held = 0  # recording() blocks open
    self._spans = collections.deque(maxlen=capacity)
    self._dropped = 0
    self._counters: Dict[str, int] = {}
    self._anchors: List[Anchor] = []
    self._open: List[list] = []  # [name, start, id, parent, step], inner last
    self._ids = itertools.count()
    self._closer = _Closer(self)

  def _switch(self, on: bool) -> None:
    if on != self.on:
      self._anchors.append(anchor())
      self.on = on
      self._open.clear()

  def span(self, name: str, step: Optional[int] = None):
    """Begins the span `name` inside the innermost open one, with its step;
    a span that opens inside none takes `step`, or else its own id."""
    if not self.on:
      return NOOP
    i = next(self._ids)
    op = self._open
    if op:
      step = op[-1][4]
    elif step is None:
      step = i
    op.append([name, _clock(), i, op[-1][2] if op else -1, step])
    return self._closer

  def root(self, name: str, step: Optional[int] = None):
    """A superstep's span. It first turns the recorder on while
    torch.profiler records and off once none does (unless `recording()`
    holds it on), and drops the spans an exception left open."""
    if not self._held and self.on != _autograd_profiler._is_profiler_enabled:
      self._switch(not self.on)
    if not self.on:
      return NOOP
    self._open.clear()
    return self.span(name, step)

  def end(self) -> None:
    """Ends the innermost open span."""
    if not self.on or not self._open:
      return
    name, start, i, parent, step = self._open.pop()
    if len(self._spans) == self._spans.maxlen:
      self._dropped += 1
    self._spans.append(Span(name, start, _clock(), i, parent, step))

  def count(self, name: str, n: int = 1) -> None:
    if self.on:
      self._counters[name] = self._counters.get(name, 0) + n

  def host_read(self, tensor: torch.Tensor, name: str):
    """`tensor.tolist()`: the host waits for the device. Inside the span
    `sync.<name>`, counted under `host_syncs`."""
    if not self.on:
      return tensor.tolist()
    self.span("sync." + name)
    out = tensor.tolist()
    self.end()
    self.count("host_syncs")
    return out

  @contextlib.contextmanager
  def recording(self) -> Iterator["Recorder"]:
    """The recorder on for the block (blocks may nest)."""
    self._held += 1
    self._switch(True)
    try:
      yield self
    finally:
      self._held -= 1
      if not self._held:
        self._switch(False)

  def drain(self) -> Drained:
    """The spans and counters since the last drain, and the anchors to map
    them by; the buffer and counters are then empty."""
    spans = sorted(self._spans, key=lambda s: s.id)
    out = Drained(spans, dict(self._counters), self._dropped,
                  list(self._anchors))
    self._spans.clear()
    self._counters.clear()
    self._dropped = 0
    self._anchors = self._anchors[-1:] if self.on else []
    return out


# One recorder a process, as torch.profiler is one a process: spans come
# from code at every depth of the program, which no caller hands an object.
RECORDER = Recorder()
span = RECORDER.span
root = RECORDER.root
end = RECORDER.end
count = RECORDER.count
host_read = RECORDER.host_read
recording = RECORDER.recording
drain = RECORDER.drain


class _NoFence:
  def lap(self, name: str) -> None:
    pass


_NO_FENCE = _NoFence()


class Fence:
  """Fenced stage laps: `lap(name)` synchronizes the device, then adds the
  seconds since the previous lap (or since the fence was made, after a
  synchronize) to `timings[name]`."""

  def __init__(self, device: torch.device, timings: Dict[str, float]):
    self.timings = timings
    self.device = device
    self._sync()
    self._t = _clock()

  def _sync(self) -> None:
    if self.device.type == "cuda":
      torch.cuda.synchronize(self.device)

  def lap(self, name: str) -> None:
    self._sync()
    now = _clock()
    self.timings[name] = self.timings.get(name, 0.0) + (now - self._t) / 1e9
    self._t = now


def fence(device: torch.device, timings: Optional[Dict[str, float]]):
  """A Fence over `timings`, or, where it is None, an object whose laps do
  nothing."""
  return _NO_FENCE if timings is None else Fence(device, timings)


def _chrome_events(drained: Drained, base_ns: int = 0) -> List[dict]:
  """The spans as Chrome trace events on one track of this process, in µs
  of torch.profiler's clock after `base_ns`."""
  pid = os.getpid()
  us = lambda t: (profiler_ns(t, drained.anchors) - base_ns) / 1e3
  out = [dict(ph="M", name="thread_name", pid=pid, tid=0,
              args=dict(name="program spans"))]
  for s in drained.spans:
    a = us(s.start_ns)
    out.append(dict(ph="X", cat="program_span", name=s.name, pid=pid, tid=0,
                    ts=a, dur=us(s.end_ns) - a,
                    args=dict(id=s.id, parent=s.parent, step=s.step)))
  return out


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
  """Profiles the enclosed block with the recorder on; yields the profiler
  (for `key_averages()` after the block) and on exit writes
  `trace_<pid>_<ns>.json` into `logdir`, whose path is then the profiler's
  `trace_path`, with the recorder's spans on a track of their own."""
  activities = [torch.profiler.ProfilerActivity.CPU]
  if torch.cuda.is_available():
    activities.append(torch.profiler.ProfilerActivity.CUDA)
  prof = torch.profiler.profile(activities=activities)
  prof.start()
  try:
    with recording():
      yield prof
  finally:
    prof.stop()
    os.makedirs(logdir, exist_ok=True)
    prof.trace_path = os.path.join(
        logdir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(prof.trace_path)
    with open(prof.trace_path) as f:
      doc = json.load(f)
    doc["traceEvents"] += _chrome_events(drain(),
                                         doc.get("baseTimeNanoseconds", 0))
    with open(prof.trace_path, "w") as f:
      json.dump(doc, f)


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
